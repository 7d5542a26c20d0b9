"""Milliseconds a frame of kernel time launched while the host's innermost
program span was kani.shade (passes/frame.band_shade and band_surface:
shade_lit or the mode's shader, then the surface encode)."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "kani.shade")
