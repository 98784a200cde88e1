"""Serving runtime: per-request SLO accounting."""

from repro_torch.runtime.slo import SLOTracker

__all__ = ["SLOTracker"]
