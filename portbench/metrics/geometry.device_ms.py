"""Milliseconds a frame of kernel time launched while the host's innermost
program span was kani.geometry (passes/frame.frame_geometry: the vertex
stage, the camera setup, the triangle records and the camera bins; the
light-space setup and bins inside it record kani.shadow)."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx, "kani.geometry")
