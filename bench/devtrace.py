"""The profiler's trace of a short window, reduced to what the per-layer
metrics read: the device's busy seconds (the union of its operations'
intervals), each kernel's launches and device seconds, the longest idle
gaps labelled by what the host was doing, and the window's length.

The benchmark's own spans (``torch.profiler.record_function`` names
starting ``bench.``) label the host's side of each gap.
"""

from __future__ import annotations

import dataclasses
import re
import time

WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class Trace:
    window_s: float                 # the traced window, host clock
    busy_s: float                   # union of the device's intervals
    ops: list                       # (name, start_us, end_us) on the device
    gaps: list                      # (host label, seconds), longest first

    def kernel(self, pattern: str) -> tuple[float, int]:
        """(device seconds, launches) of the ops whose names match the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [(b - a) for name, a, b in self.ops if rx.search(name)]
        return sum(hits) * 1e-6, len(hits)

    def breakdown(self) -> dict:
        by_name: dict = {}
        for name, a, b in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n[:160], s] for n, s in self.gaps[:10]]}


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _label(cpu, t: float) -> str:
    """The innermost host event running at ``t`` (µs)."""
    best = None
    for name, a, b in cpu:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best is not None else "host: no event"


def _device_ops(torch, prof) -> list:
    """(name, start_us, end_us) of every operation that ran on the device;
    the device side of a ``record_function`` span is an annotation over the
    ops it holds, not an op."""
    dev_type = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == dev_type and not e.name.startswith("bench.")]


def profile(torch, fn, sync, on_device: bool):
    """Run ``fn()`` twice under ``torch.profiler``: once tracing the device
    alone, for the busy seconds, the window and the kernels (host tracing
    slows the host and would open gaps that untraced runs do not have), and
    once tracing host and device, for what the host was doing in each idle
    gap.  Returns a :class:`Trace`, or None off the card."""
    if not on_device:
        return None
    act = torch.profiler.ProfilerActivity
    sync()
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    ops = _device_ops(torch, prof)
    if not ops:
        return None
    busy_us = sum(b - a for a, b in _union((a, b) for _, a, b in ops))

    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            fn()
            sync()
    traced = _device_ops(torch, prof)
    dev_type = torch.autograd.DeviceType.CUDA
    cpu = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type != dev_type]
    span = [(a, b) for name, a, b in cpu if name == WINDOW_SPAN]
    gaps = []
    if span and traced:
        lo, hi = span[0]
        merged = _union((max(a, lo), min(b, hi)) for _, a, b in traced
                        if min(b, hi) > max(a, lo))
        edges = [lo] + [x for seg in merged for x in seg] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
    inner = [(n, a, b) for n, a, b in cpu if n != WINDOW_SPAN]
    labelled = [(_label(inner, 0.5 * (a + b)), (b - a) * 1e-6)
                for a, b in gaps[:10]]
    return Trace(window_s=window_s, busy_s=busy_us * 1e-6, ops=ops,
                 gaps=labelled)
