"""Kernel launches a frame in the traced window: the runtime and driver
launch calls (cudaLaunchKernel, cuLaunchKernel) over the frames."""

from portbench import trace as tr


def read(ctx):
    if ctx.trace.frames <= 0:
        return None
    return tr.count(ctx.trace, tr.LAUNCHES) / ctx.trace.frames
