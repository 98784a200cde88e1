"""Serving runtime: per-request SLO accounting, failure injection and the
analog tile grid's recovery planning."""

from repro_torch.runtime.elastic import TileRecoveryPlan, plan_tile_recovery
from repro_torch.runtime.failures import Failure, FailureInjector, tile_row_failures
from repro_torch.runtime.slo import SLOTracker

__all__ = ["Failure", "FailureInjector", "SLOTracker", "TileRecoveryPlan",
           "plan_tile_recovery", "tile_row_failures"]
