"""The traffic generator: the same events for a seed, another order for
another seed, and a path that stays inside the courtyard."""

import itertools
import json

import numpy as np
import pytest

from portbench import traffic
from portbench.tests.conftest import ROOT

MIXES = ["fly-fresh", "fly-cached", "fly-wire"]


def load(name):
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 10**12 + 3, -7])
def test_events_deterministic_per_seed(seed):
    mix = load("fly-fresh")
    a = list(itertools.islice(traffic.events(mix, seed), 500))
    b = list(itertools.islice(traffic.events(mix, seed), 500))
    assert a == b
    c = list(itertools.islice(traffic.events(mix, seed + 1), 500))
    assert a != c


def test_first_event_presses_f1_once():
    evs = list(itertools.islice(traffic.events(load("fly-wire"), 3), 300))
    assert evs[0].pressed == frozenset({"f1"})
    assert all(not e.pressed for e in evs[1:])
    assert all("w" in e.held and e.mouse_look for e in evs)


@pytest.mark.parametrize("name,seed", [(m, s) for m in MIXES
                                       for s in (1, 2**31 + 5, 77777)])
def test_path_stays_in_courtyard(name, seed):
    ps = traffic.poses(load(name), seed, 4000)
    p = np.array([q[0] for q in ps])
    assert np.abs(p[:, 0]).max() < 1200.0
    assert np.abs(p[:, 2]).max() < 600.0
    assert ((p[:, 1] >= 0.0) & (p[:, 1] <= 500.0)).all()


def test_segments_same_multiset_for_every_seed():
    mix = load("fly-fresh")
    segs = traffic.segments(mix)
    assert len(segs) == mix["segments"]
    frames = sorted(f for f, _, _ in segs)
    lo, hi = mix["segment_seconds"]
    assert frames[0] == round(lo * 60) and frames[-1] == round(hi * 60)
    rates = sorted(abs(d) for _, _, d in segs)
    assert rates[0] == pytest.approx(1.0) and rates[-1] == pytest.approx(4.0)
