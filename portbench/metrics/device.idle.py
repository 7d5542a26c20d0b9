"""The share of the traced window, %, in which no operation ran on the
device: one minus the union of the trace's device intervals over the
window."""

from portbench import trace as tr


def read(ctx):
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(ctx.trace) / ctx.trace.window_s)
