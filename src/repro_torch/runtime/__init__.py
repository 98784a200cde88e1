"""Fault-tolerance runtime: straggler monitor, elastic recovery planning
(chip-level and the analog tile grid's), failure injection and per-request
SLO accounting."""

from repro_torch.runtime.elastic import (
    RecoveryPlan,
    TileRecoveryPlan,
    hosts_to_chips,
    plan_recovery,
    plan_tile_recovery,
)
from repro_torch.runtime.failures import Failure, FailureInjector, tile_row_failures
from repro_torch.runtime.slo import SLOTracker
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = ["Failure", "FailureInjector", "RecoveryPlan", "SLOTracker",
           "StragglerMonitor", "TileRecoveryPlan", "hosts_to_chips",
           "plan_recovery", "plan_tile_recovery", "tile_row_failures"]
