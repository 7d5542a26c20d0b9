"""The comparison that decides ``correct``: the program's presented u8
frames against the reference's frames of the same poses.

Per frame, two numbers, each held to its limit over every sampled frame
(the worst frame counts):

* ``px_off8``: the share of pixels where a channel lies more than 8
  levels from the reference's (a pixel that a different triangle wins, a
  texel or a shadow sample taken elsewhere);
* ``mean_diff``: the mean absolute difference over all channels, levels.

The limits were set from the readings on the card (``calibrate.py``,
PERF.md gives them all): sound runs of the program read 0 on both numbers
on every seed of every cell; the control, the reference in bfloat16
(``reference.frame.render_frame(lowp=True)``), read at least 0.056 and 7.5
(the wireframe cell, whose frames are mostly the clear colour) and 0.88
and 95 in the shaded cells.  Each limit lies between, a little nearer the
control than the program.
"""

from __future__ import annotations

import numpy as np

LIMITS = {"px_off8": 0.03, "mean_diff": 4.0}


# What a frame of the wrong shape, or a sampled frame that never came,
# reads.
MISSING = {"px_off8": 1.0, "mean_diff": 255.0}


def frame_numbers(got: np.ndarray, want: np.ndarray) -> dict:
    """The compared numbers of one frame."""
    if got.shape != want.shape:
        return dict(MISSING)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return {"px_off8": float((diff.max(-1) > 8).mean()),
            "mean_diff": float(diff.mean())}


def worst(numbers: list) -> dict:
    """The worst reading of each number over the frames."""
    return {k: max(n[k] for n in numbers) for k in LIMITS}


def within(values: dict) -> bool:
    return all(values[k] <= LIMITS[k] for k in LIMITS)
