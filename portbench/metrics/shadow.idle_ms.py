"""Milliseconds a frame in which the device was idle while the host's
innermost program span was kani.shadow (the light-space setup and bins,
K1, the PCF table build)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "kani.shadow")
