"""The shading kernel (csrc/shade_forward.cu, forward LIT and LIT_SHADOW
onto the u8 surface): its share, %, of its roofline. The bound is the
larger of its work's bytes over the HBM rate and its operations over the
FP32 peak (portbench/roofline.py ``shade_work``), counted from the
reference's raster of traced poses and the cell's light rig, each light
charged only on the covered pixels inside its range; it is divided by the
kernel's mean device time in the trace. Nothing where the trace holds no
such kernel, or where the surface is HDR, which the count does not
cover."""

import statistics

from portbench import roofline
from portbench import trace as tr

# The kernel's name as the trace gives it (demangled, template arguments
# included).
KERNEL = "shade_forward_kernel<"


def read(ctx):
    times = tr.kernel_times(ctx.trace, lambda name: KERNEL in name)
    if not times or ctx.config.hdr:
        return None
    bound, _ = roofline.bound_ms(*ctx.work("shade"))
    return 100.0 * bound / statistics.fmean(times)
