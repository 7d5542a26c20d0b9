"""frame_ms and frame_p95_ms on synthetic host-clock stamps."""

import pytest

from portbench import stats


def stamps(intervals_ms, t0=100.0):
    out = [t0]
    for d in intervals_ms:
        out.append(out[-1] + d / 1e3)
    return out


def test_steady_window():
    s = stamps([20.0] * 500)
    assert stats.frame_ms(s[0], s[-1], 500) == pytest.approx(20.0)
    assert stats.percentile(stats.intervals_ms(s), 95) == pytest.approx(20.0)


def test_one_stall_moves_both():
    # 19 frames of 60 ms and one 500 ms stall: at 2160p's rate a window
    # this short still has its stall beyond the 95th percentile.
    steady = stamps([60.0] * 20)
    stall = stamps([60.0] * 19 + [500.0])
    assert stats.frame_ms(stall[0], stall[-1], 20) \
        == pytest.approx(stats.frame_ms(steady[0], steady[-1], 20) + 22.0)
    assert stats.percentile(stats.intervals_ms(stall), 95) \
        > stats.percentile(stats.intervals_ms(steady), 95) + 10.0


def test_long_window_mean_sees_one_stall_tail_sees_many():
    steady = stamps([20.0] * 500)
    stall = stamps([20.0] * 499 + [500.0])
    assert stats.frame_ms(stall[0], stall[-1], 500) \
        == pytest.approx(20.0 + 480.0 / 500)
    burst = stamps([20.0] * 470 + [500.0] * 30)
    assert stats.percentile(stats.intervals_ms(burst), 95) > 400.0
    assert stats.percentile(stats.intervals_ms(steady), 95) \
        == pytest.approx(20.0)


def test_percentile_interpolates_between_ranks():
    assert stats.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert stats.percentile([0.0, 10.0], 95) == pytest.approx(9.5)


def test_frame_ms_needs_frames():
    with pytest.raises(ValueError):
        stats.frame_ms(0.0, 1.0, 0)
