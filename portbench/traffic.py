"""The general traffic generator: a traffic mix's parameters and a seed → the
per-frame input events of a fly-through.

Every seed flies the same multiset of segments in another order: each
segment holds W, with or without a strafe key, and turns the mouse by a
fixed number of pixels a frame, for a fixed number of frames.  The
camera's pose is followed with the reference's own controller
(``reference/frame.step_pose``), and where the point ``lookahead`` units
ahead of the camera leaves the mix's box, the segment's turn is taken
towards the box's centre at the largest rate and its strafe is dropped,
so the path stays inside the courtyard; a strafe that would carry the
lookahead out of the box is dropped.  The first event presses F1 (the
loop's present mode goes from AutoVsync to AutoNoVsync: no frame pacing).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from portbench.reference.frame import start_pose, step_pose


class Event(NamedTuple):
    """One frame's input, the fields of the program's ``Events``."""

    held: frozenset
    pressed: frozenset
    mouse_dx: float
    mouse_dy: float
    mouse_look: bool


def segments(mix: dict) -> list:
    """The mix's multiset of (frames, strafe key, mouse dx) segments, in a
    fixed order: durations and turn rates evenly over their ranges, the
    turn's sign alternating and the strafe keys in turn."""
    n = mix["segments"]
    fps = round(1.0 / mix["fixed_dt"])
    lo, hi = mix["segment_seconds"]
    durations = np.linspace(lo, hi, n)
    rates = np.linspace(*mix["look_px_per_frame"], n)
    strafes = mix["strafe_keys"]
    out = []
    for i in range(n):
        sign = 1.0 if i % 2 == 0 else -1.0
        out.append((int(round(durations[i] * fps)), strafes[i % len(strafes)],
                    float(sign * rates[(i * 7) % n])))
    return out


# The direction of travel, relative to the heading, with each strafe key.
_STRAFE_ANGLE = {"": 0.0, "a": -np.pi / 4, "d": np.pi / 4}


def _heading_in(pos, angle, box, lookahead) -> bool:
    ahead = pos[[0, 2]] + lookahead * np.array([np.cos(angle),
                                                np.sin(angle)])
    return bool(abs(ahead[0]) <= box[0] and abs(ahead[1]) <= box[1])


def _turn_sign(pos, yaw) -> float:
    """+1 where turning by +yaw brings the heading towards the centre."""
    to_centre = np.arctan2(-pos[2], -pos[0])
    d = (to_centre - yaw + np.pi) % (2 * np.pi) - np.pi
    return 1.0 if d >= 0 else -1.0


def events(mix: dict, seed: int) -> Iterator[Event]:
    """The endless event stream of ``mix`` for ``seed``: the segments in an
    order drawn from the seed, again in a new order once all have run."""
    rng = np.random.default_rng(seed % 2**64)   # any whole number
    segs = segments(mix)
    box = mix["box_xz"]
    look = mix["lookahead"]
    top = max(abs(d) for _, _, d in segs)
    dt = mix["fixed_dt"]
    pose = start_pose()
    first = True
    while True:
        for k in rng.permutation(len(segs)):
            frames, strafe, dx = segs[k]
            for _ in range(frames):
                held = {"w"}
                turn = dx
                if _heading_in(pose[0], pose[1] + _STRAFE_ANGLE[strafe],
                               box, look):
                    if strafe:
                        held.add(strafe)
                elif not _heading_in(pose[0], pose[1], box, look):
                    turn = _turn_sign(pose[0], pose[1]) * top
                ev = Event(held=frozenset(held),
                           pressed=frozenset({"f1"}) if first
                           else frozenset(),
                           mouse_dx=turn, mouse_dy=0.0, mouse_look=True)
                first = False
                pose = step_pose(pose, ev.held, ev.mouse_dx, ev.mouse_dy,
                                 ev.mouse_look, dt)
                yield ev


def poses(mix: dict, seed: int, frames: int) -> list:
    """The camera pose of each of the first ``frames`` frames: the pose
    the loop renders frame g with, after g + 1 controller steps."""
    out = []
    pose = start_pose()
    for ev, _ in zip(events(mix, seed), range(frames)):
        pose = step_pose(pose, ev.held, ev.mouse_dx, ev.mouse_dy,
                         ev.mouse_look, mix["fixed_dt"])
        out.append(pose)
    return out
