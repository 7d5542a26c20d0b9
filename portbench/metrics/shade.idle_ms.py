"""Milliseconds a frame in which the device was idle while the host's
innermost program span was kani.shade (band_shade and band_surface)."""

from portbench import spans


def read(ctx):
    return spans.idle_ms(ctx, "kani.shade")
