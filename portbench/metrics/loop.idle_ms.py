"""Milliseconds a frame in which the device was idle while the host's
innermost program span was kani.frame: the loop's own host code
(hotkeys, controllers, the uniforms, the state upload and its wait),
outside every stage's span."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "kani.frame")
