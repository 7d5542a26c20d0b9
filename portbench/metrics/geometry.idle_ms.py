"""Milliseconds a frame in which the device was idle while the host's
innermost program span was kani.geometry (passes/frame.frame_geometry:
its launches and read-backs)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "kani.geometry")
