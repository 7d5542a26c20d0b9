"""End-to-end frame statistics from the host clock's stamps."""

from __future__ import annotations

import math


def frame_ms(t0: float, t_end: float, frames: int) -> float:
    """The window's wall time over the frames completed in it, ms."""
    if frames <= 0:
        raise ValueError("no frame completed in the window")
    return (t_end - t0) * 1e3 / frames


def intervals_ms(stamps: list) -> list:
    """Frame-to-frame intervals, ms, between consecutive stamps."""
    return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100), linear between the closest ranks."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)
