"""Milliseconds a frame in which an operation ran on the device: the union
of the traced window's device intervals over its frames."""

from portbench import trace as tr


def read(ctx):
    if ctx.trace.frames <= 0:
        return None
    return tr.busy_s(ctx.trace) * 1e3 / ctx.trace.frames
