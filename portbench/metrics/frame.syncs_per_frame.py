"""Calls that make the host wait for the device, a frame, in the traced
window: cudaStreamSynchronize, cudaDeviceSynchronize and
cudaEventSynchronize over the frames."""

from portbench import trace as tr


def read(ctx):
    if ctx.trace.frames <= 0:
        return None
    return tr.count(ctx.trace, tr.SYNCS) / ctx.trace.frames
