"""Per-request SLO accounting for the serving engine.

The serving contract the ROADMAP's "millions of users" story is measured
against is not a single batched call — it is *sustained* service under a
dynamic request stream: how many requests per second, at what tick
latency, and what happened to every request that did NOT get served
(expired past its deadline, rejected at admission, recovered mid-stream).
:class:`SLOTracker` is the one place those numbers accumulate; the
engine calls ``count``/``record_tick`` and everything else (tests,
``chip_smoke.py``, operator dashboards) reads ``summary()``.

Latencies are recorded per engine *tick* — one fixed-shape device call —
because that is the quantum the slot loop schedules in: a request's
end-to-end latency is (queue wait in ticks) x (tick latency), and the
two factors are exactly the knobs an operator has (slots/admission vs
kernel/batch shape).
"""

from __future__ import annotations

import time

import numpy as np

#: counter names the tracker maintains (all start at 0):
#:   submitted — requests accepted into the queue;
#:   served    — requests completed with a result;
#:   expired   — requests that overran ``deadline_ticks`` while queued
#:               and completed as failed;
#:   rejected  — requests refused (or timed out) at admission because the
#:               bounded queue was full;
#:   recovered — mid-stream program swaps after a ``tile_down`` failure.
COUNTERS = ("submitted", "served", "expired", "rejected", "recovered")


class SLOTracker:
    """Counters + tick-latency percentiles for one serving engine."""

    def __init__(self):
        self.counters: dict[str, int] = dict.fromkeys(COUNTERS, 0)
        self.tick_latencies: list[float] = []   # seconds per engine tick
        self._t_first: float | None = None      # window of recorded ticks
        self._t_last: float | None = None

    # ------------------------------------------------------------------
    def count(self, name: str, k: int = 1) -> None:
        if name not in self.counters:
            raise KeyError(f"unknown SLO counter {name!r} "
                           f"(have {sorted(self.counters)})")
        self.counters[name] += k

    def record_tick(self, seconds: float) -> None:
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now - seconds
        self._t_last = now
        self.tick_latencies.append(seconds)

    # ------------------------------------------------------------------
    def percentile_us(self, p: float) -> float | None:
        """``p``-th percentile tick latency in microseconds (None when no
        tick has been recorded yet)."""
        if not self.tick_latencies:
            return None
        return float(np.percentile(np.asarray(self.tick_latencies), p)) * 1e6

    @property
    def window_s(self) -> float | None:
        """Wall-clock span covered by the recorded ticks."""
        if self._t_first is None:
            return None
        return self._t_last - self._t_first

    def qps(self) -> float | None:
        """Served requests per second over the recorded tick window."""
        w = self.window_s
        if not w or not self.counters["served"]:
            return None
        return self.counters["served"] / w

    def summary(self) -> dict:
        """One flat dict: counters + ticks + p50/p99 tick latency + qps."""
        out = dict(self.counters)
        out["ticks"] = len(self.tick_latencies)
        out["p50_tick_us"] = self.percentile_us(50)
        out["p99_tick_us"] = self.percentile_us(99)
        out["qps"] = self.qps()
        return out
