"""Milliseconds a frame of kernel time launched while the host's innermost
program span was kani.shadow: the whole shadow pass, wherever it runs
(the light-space setup and bins, K1, the PCF table build)."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "kani.shadow")
