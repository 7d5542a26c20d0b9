"""The program's own spans in the traced window: which layer of the frame
loop launched each kernel, and which layer held the host while the device
sat idle.

While the profiler runs, the program records ``kani.*`` spans at its
layer boundaries (``kanirenderer_tpu_torch/utils/spans.py``); they come
into ``Trace.host`` as user annotations on the trace's clock.  At each
moment the host is in the innermost ``kani.*`` span open then, or in none
(the harness's event generation between frames, the drain after the
window).

Kernels.  ``trace.read`` keeps no link between a launch call and its
kernel.  The program launches its kernels on one stream, and the harness
synchronises before ``BEGIN`` and before ``DRAINED``, so the window's
kernels ran in the order of its launch calls: the n-th launch call, in
host order, launched the n-th kernel, in device order.  A kernel counts
for the span innermost at its launch call.  Where the two counts differ
the pairing is unknown, and ``attribution`` gives None, never a guess:
a trace that lost device events would also show their time as idle.

Idle.  Each stretch of the window in which no device op ran (the
complement of ``trace.busy_intervals``) is split by the host's innermost
span over it.

A program without the spans gives a trace in which no metric of this
module finds its span: each then reads None.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

from portbench import trace as tr

PREFIX = "kani."


class Attribution(NamedTuple):
    """Per innermost span (None: outside every span) of the window."""

    seen: frozenset   # the span names that occur in the window
    device_us: dict   # kernel time launched there
    idle_us: dict     # device idle while the host was there
    launches: dict    # kernel launch calls
    syncs: dict       # calls that wait for the device
    copies_us: float  # the window's copies and sets, by no span


def program_spans(trace: tr.Trace) -> list:
    """(start us, end us, name) of the program's spans that start in the
    window, in start order."""
    return sorted((s, t, n) for s, t, n in trace.host
                  if n.startswith(PREFIX)
                  and trace.begin_us <= s < trace.drained_us)


def innermost(spans: list) -> list:
    """The host's timeline from properly nested spans: (start, end, name)
    segments, in order, each naming the innermost span open over it;
    time outside every span has no segment.  A child's end is clipped to
    its parent's."""
    out, stack = [], []   # stack: [end, name] of the open spans
    at = None

    def close_until(t):
        nonlocal at
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > at:
                out.append((at, end, name))
            at = end

    for s, t, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        if stack and s > at:
            out.append((at, s, stack[-1][1]))
        at = s
        stack.append([min(t, stack[-1][0]) if stack else t, name])
    close_until(float("inf"))
    return out


def _span_at(starts: list, segments: list, ts: float):
    k = bisect.bisect_right(starts, ts) - 1
    if k >= 0 and ts < segments[k][1]:
        return segments[k][2]
    return None


def _idle(trace: tr.Trace) -> list:
    """[start, end] of the window's stretches with no device op."""
    gaps, last = [], trace.begin_us
    for s, t in tr.busy_intervals(trace) + [[trace.drained_us,
                                             trace.drained_us]]:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    return gaps


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _attribute(trace: tr.Trace) -> Attribution | None:
    spans = program_spans(trace)
    segments = innermost(spans)
    starts = [s for s, _, _ in segments]
    in_window = sorted((s, t, n) for s, t, n in trace.host
                       if trace.begin_us <= s < trace.drained_us)
    launches = []
    for s, t, n in in_window:
        # A cuLaunchKernel inside a cudaLaunchKernel is that launch.
        if n in tr.LAUNCHES and not (launches and s < launches[-1][1]):
            launches.append((s, t))
    kernels = [(s, t) for s, t, n in trace.device if _is_kernel(n)]
    if len(launches) != len(kernels):
        return None

    def add(d, key, v):
        d[key] = d.get(key, 0) + v

    device, idle, launched, syncs = {}, {}, {}, {}
    for (ls, _), (ks, kt) in zip(launches, kernels):
        where = _span_at(starts, segments, ls)
        add(device, where, kt - ks)
        add(launched, where, 1)
    for s, _, n in in_window:
        if n in tr.SYNCS:
            add(syncs, _span_at(starts, segments, s), 1)
    k = 0
    for a, b in _idle(trace):
        while k < len(segments) and segments[k][1] <= a:
            k += 1
        j, at = k, a
        while j < len(segments) and segments[j][0] < b:
            s, t, name = segments[j]
            if s > at:
                add(idle, None, s - at)
            lo, hi = max(s, at), min(t, b)
            add(idle, name, hi - lo)
            at = hi
            j += 1
        if b > at:
            add(idle, None, b - at)
    copies = sum(t - s for s, t, n in trace.device if not _is_kernel(n))
    return Attribution(frozenset(n for _, _, n in spans), device, idle,
                       launched, syncs, copies)


_last = (None, None)


def attribution(trace: tr.Trace) -> Attribution | None:
    """``trace``'s attribution, computed once for the trace the readers
    share."""
    global _last
    if _last[0] is not trace:
        _last = (trace, _attribute(trace))
    return _last[1]


def _per_frame_ms(ctx, name: str, field: str):
    if ctx.trace.frames <= 0:
        return None
    att = attribution(ctx.trace)
    if att is None or name not in att.seen:
        return None
    return getattr(att, field).get(name, 0.0) * 1e-3 / ctx.trace.frames


def device_ms(ctx, name: str):
    """Milliseconds a frame of kernel time launched with ``name`` the
    innermost span; None where the window has no such span or the
    launches cannot be paired with the kernels."""
    return _per_frame_ms(ctx, name, "device_us")


def idle_ms(ctx, name: str):
    """Milliseconds a frame of device idle while ``name`` was the host's
    innermost span; None as for ``device_ms``."""
    return _per_frame_ms(ctx, name, "idle_us")


def host_ms(ctx, name: str):
    """Milliseconds a frame of the host's time in the spans named
    ``name``, from their durations; None where there are none."""
    durations = [t - s for s, t, n in program_spans(ctx.trace) if n == name]
    if ctx.trace.frames <= 0 or not durations:
        return None
    return sum(durations) * 1e-3 / ctx.trace.frames
