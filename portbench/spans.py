"""The program's own spans in the traced window: which layer of the frame
loop launched each kernel, and which layer held the host while the device
sat idle.

While the profiler runs, the program records ``kani.*`` spans at its
layer boundaries (``kanirenderer_tpu_torch/utils/spans.py``); they come
into ``Trace.host`` as user annotations on the trace's clock.  At each
moment the host is in the innermost ``kani.*`` span open then, or in none
(the harness's event generation between frames, the drain after the
window).

Kernels.  Each launch call that starts in the window finds its kernel
by the correlation id that the profiler gives both (``Trace.kernels``),
wherever the kernel's record lies in time: the records of kernels
launched near the window's ends can fall outside the window's markers,
and records of kernels launched outside it inside them.  A kernel counts,
whole, for the span innermost at its launch call.  Where a launch call
has no kernel record, the kernel time by span is unknown, and
``Attribution.device_us`` is None, never a guess.

Idle.  Each stretch of the window in which no device op ran (the
complement of ``trace.busy_intervals``) is split by the host's innermost
span over it.

A program without the spans gives a trace in which no metric of this
module finds its span: each then reads None.
"""

from __future__ import annotations

import bisect
import sys
from typing import NamedTuple

from portbench import trace as tr

PREFIX = "kani."


class Attribution(NamedTuple):
    """Per innermost span (None: outside every span) of the window."""

    seen: frozenset   # the span names that occur in the window
    device_us: dict   # kernel time launched there; None: not paired
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


def _launches(trace: tr.Trace) -> list:
    """[start, end, correlation ids] of the window's launches, in order:
    a launch call nested in another (a cuLaunchKernel inside a
    cudaLaunchKernel) is part of that launch."""
    out = []
    for s, t, corr in trace.launches:
        if out and s < out[-1][1]:
            out[-1][2].add(corr)
        else:
            out.append([s, t, {corr}])
    return out


def _attribute(trace: tr.Trace) -> Attribution:
    spans = program_spans(trace)
    segments = innermost(spans)
    starts = [s for s, _, _ in segments]

    def add(d, key, v):
        d[key] = d.get(key, 0) + v

    device, idle, launched, syncs = {}, {}, {}, {}
    unpaired = 0
    for ls, _, ids in _launches(trace):
        where = _span_at(starts, segments, ls)
        add(launched, where, 1)
        found = [trace.kernels[c] for c in ids if c in trace.kernels]
        if len(found) != 1:
            unpaired += 1
            continue
        ks, kt = found[0]
        add(device, where, kt - ks)
    if unpaired:
        print(f"portbench.spans: {unpaired} of the traced window's launch "
              "calls have no kernel record; no kernel time by span",
              file=sys.stderr, flush=True)
        device = None
    for s, _, n in trace.host:
        if n in tr.SYNCS and trace.begin_us <= s < trace.drained_us:
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


def attribution(trace: tr.Trace) -> Attribution:
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
    by_span = getattr(att, field)
    if name not in att.seen or by_span is None:
        return None
    return by_span.get(name, 0.0) * 1e-3 / ctx.trace.frames


def device_ms(ctx, name: str):
    """Milliseconds a frame of kernel time launched with ``name`` the
    innermost span; None where the window has no such span or a launch
    call has no kernel record."""
    return _per_frame_ms(ctx, name, "device_us")


def idle_ms(ctx, name: str):
    """Milliseconds a frame of device idle while ``name`` was the host's
    innermost span; None where the window has no such span."""
    return _per_frame_ms(ctx, name, "idle_us")


def host_ms(ctx, name: str):
    """Milliseconds a frame of the host's time in the spans named
    ``name``, from their durations; None where there are none."""
    durations = [t - s for s, t, n in program_spans(ctx.trace) if n == name]
    if ctx.trace.frames <= 0 or not durations:
        return None
    return sum(durations) * 1e-3 / ctx.trace.frames
