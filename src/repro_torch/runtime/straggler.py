"""Straggler mitigation: per-host step-latency tracking.

At multi-pod scale a slow host stalls every synchronous collective.  The
monitor keeps an EWMA + variance of per-host step times and flags hosts
whose latency exceeds ``mean + k * std`` (and a relative floor) for several
consecutive steps.  The driver's policy on a flagged host:

  1. log + alert (always);
  2. if persistent, treat as failed: checkpoint, drop the host, re-mesh via
     :mod:`repro_torch.runtime.elastic` and restart from the last durable step.

The counterpart of the JAX package's ``repro.runtime.straggler``, numpy
only; the decision logic is unit-testable offline (tests feed synthetic
timings).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    num_hosts: int
    alpha: float = 0.2            # EWMA weight
    k_sigma: float = 3.0          # flag threshold in std units
    rel_floor: float = 1.3        # and at least 30% slower than fleet mean
    patience: int = 3             # consecutive flags before "persistent"

    def __post_init__(self):
        self.mean = np.zeros(self.num_hosts)
        self.var = np.zeros(self.num_hosts)
        self.count = 0
        self.flags = np.zeros(self.num_hosts, np.int64)

    def observe(self, step_times: np.ndarray) -> list[int]:
        """Feed one step's per-host wall times; returns flagged host ids."""
        t = np.asarray(step_times, np.float64)
        if self.count == 0:
            self.mean[:] = t
        else:
            d = t - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.count += 1
        fleet = float(np.median(self.mean))
        sigma = float(np.sqrt(np.maximum(self.var.mean(), 1e-12)))
        flagged = []
        for h in range(self.num_hosts):
            slow = (self.mean[h] > fleet + self.k_sigma * sigma
                    and self.mean[h] > self.rel_floor * fleet
                    and self.count >= 3)
            self.flags[h] = self.flags[h] + 1 if slow else 0
            if slow:
                flagged.append(h)
        return flagged

    def persistent(self) -> list[int]:
        """Hosts flagged for >= patience consecutive steps (treat as failed)."""
        return [h for h in range(self.num_hosts)
                if self.flags[h] >= self.patience]
