"""K2w, K2's wireframe variant (csrc/raster_pixels.cu, kWire true): its
share, %, of its roofline. The bound is the larger of its work's bytes
over the HBM rate and its operations over the FP32 peak
(portbench/roofline.py), counted from the reference's setup of traced
poses; it is divided by the kernel's mean device time in the trace.
Nothing where the trace holds no such kernel."""

import statistics

from portbench import roofline
from portbench import trace as tr

# The kernel's name as the trace gives it (demangled, template arguments
# included).
KERNEL = "raster_pixels_kernel<true"


def read(ctx):
    times = tr.kernel_times(ctx.trace, lambda name: KERNEL in name)
    if not times:
        return None
    bound, _ = roofline.bound_ms(*ctx.work("pixels"))
    return 100.0 * bound / statistics.fmean(times)
