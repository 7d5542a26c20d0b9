"""The traced window: what ``torch.profiler`` saw of it, read from its
Chrome trace.

The counting is a frozen copy of ``kanirenderer_tpu_torch/runtime/
loop_profile.py`` (commit 1e399aa): its launch and synchronisation calls
counted per frame.  Its busy share divided the device time by a wall clock
that the profiler had slowed and summed kernel times that may overlap;
here the device's busy time is the union of the trace's device intervals
(kernels, copies, sets) and the window is the trace's own, between two
markers the harness places.
"""

from __future__ import annotations

import json
from typing import NamedTuple

BEGIN, END, DRAINED = ("portbench.window_begin", "portbench.window_end",
                       "portbench.device_drained")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Trace(NamedTuple):
    frames: int          # frames whose events were asked for in the window
    begin_us: float      # trace time of the window's first frame
    end_us: float        # trace time after the window's last frame (host)
    drained_us: float    # trace time once the device had finished
    device: list         # (start_us, end_us, name) of every device op
    host: list           # (start_us, end_us, name) of the host's ops
    calls: dict          # runtime call name → count within the window
    launches: list       # (start_us, end_us, correlation) of the launch
    #                      calls that start in the window, in start order
    kernels: dict        # correlation → (start_us, end_us) of every kernel
    #                      record of the trace, in the window or not

    @property
    def window_s(self) -> float:
        return (self.drained_us - self.begin_us) * 1e-6


def read(path: str, frames: int) -> Trace:
    """The window of the trace at ``path`` (a Chrome trace written by
    ``torch.profiler``), over ``frames`` frames.  The profiler gives a
    launch call and the kernel it launched one correlation id."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = {}
    device, host, launches, kernels = [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        name, cat = e.get("name", ""), e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if name in (BEGIN, END, DRAINED):
            marks[name] = ts
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, name))
            if cat == "kernel" and corr is not None:
                kernels[corr] = (ts, ts + dur)
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, name))
            if name in LAUNCHES:
                launches.append((ts, ts + dur, corr))
    missing = {BEGIN, END, DRAINED} - set(marks)
    if missing:
        raise ValueError(f"trace lacks the markers {sorted(missing)}")
    b, e, d = marks[BEGIN], marks[END], marks[DRAINED]
    calls = {}
    for s, _, name in host:
        if b <= s < e and name in LAUNCHES + SYNCS:
            calls[name] = calls.get(name, 0) + 1
    device = sorted((max(s, b), min(t, d), n) for s, t, n in device
                    if t > b and s < d)
    launches = sorted((x for x in launches if b <= x[0] < d),
                      key=lambda x: x[:2])
    return Trace(frames, b, e, d, device, host, calls, launches, kernels)


def busy_intervals(trace: Trace) -> list:
    """The union of the device's op intervals in the window, in order."""
    out = []
    for s, t, _ in trace.device:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_s(trace: Trace) -> float:
    return sum(t - s for s, t in busy_intervals(trace)) * 1e-6


def count(trace: Trace, names) -> int:
    return sum(trace.calls.get(n, 0) for n in names)


def kernel_times(trace: Trace, match) -> list:
    """Durations, ms, of the device ops whose name ``match`` accepts."""
    return [(t - s) * 1e-3 for s, t, n in trace.device if match(n)]


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without anonymous namespaces and its parameter
    list, at most ``width`` characters; a copy's or a set's as it is."""
    name = name.replace("(anonymous namespace)::", "")
    if "::" in name:
        name = name.split("(", 1)[0]
    return name[:width]


def top_device_ops(trace: Trace, n: int = 10) -> list:
    """[name, seconds] of the ``n`` device ops that took the most time,
    each under its short name."""
    total = {}
    for s, t, name in trace.device:
        name = short_name(name)
        total[name] = total.get(name, 0.0) + (t - s) * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:n]]


def _host_op_at(trace: Trace, ts: float) -> str:
    """The innermost host op running at ``ts`` (the latest started)."""
    best = None
    for s, t, name in trace.host:
        if s <= ts < t and (best is None or s > best[0]):
            best = (s, name)
    return best[1] if best else "(host code outside any traced op)"


def idle_gaps(trace: Trace, n: int = 10) -> list:
    """[host op, seconds] of the ``n`` longest stretches of the window in
    which no device op ran, each named by the host op running at its
    middle."""
    gaps, last = [], trace.begin_us
    for s, t in busy_intervals(trace) + [[trace.drained_us,
                                          trace.drained_us]]:
        if s > last:
            gaps.append((s - last, last, s))
        last = max(last, t)
    gaps.sort(reverse=True)
    return [[_host_op_at(trace, (a + b) / 2), g * 1e-6]
            for g, a, b in gaps[:n]]
