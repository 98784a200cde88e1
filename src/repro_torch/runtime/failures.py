"""Failure injection for the serving engine's fault-tolerance path: the
counterpart of the JAX package's ``repro.runtime.failures``.

Fires failures on a schedule, so the recovery path is exercised
deterministically:

  * ``host_down``  — a host stops heartbeating (drop its chips);
  * ``straggler``  — a host's step time inflates by a factor;
  * ``crash``      — the process dies mid-step;
  * ``tile_down``  — a physical analog tile (or, scheduled per tile, a
    whole tile row) drops out of the (To x Ti) grid: serving recovers by
    remapping the placement (``runtime.elastic.plan_tile_recovery`` and
    ``compile.recover_tiled``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Failure:
    step: int
    kind: str              # host_down | straggler | crash | tile_down
    host: int = 0
    factor: float = 5.0    # straggler slowdown
    tile: tuple[int, int] = (0, 0)   # tile_down: physical (row, col)


@dataclasses.dataclass
class FailureInjector:
    schedule: list[Failure]
    down_hosts: set = dataclasses.field(default_factory=set)
    slow_hosts: dict = dataclasses.field(default_factory=dict)
    dead_tiles: set = dataclasses.field(default_factory=set)

    def at_step(self, step: int) -> list[Failure]:
        """The failures scheduled at ``step``, applied to the state."""
        fired = [f for f in self.schedule if f.step == step]
        for f in fired:
            if f.kind == "host_down":
                self.down_hosts.add(f.host)
            elif f.kind == "straggler":
                self.slow_hosts[f.host] = f.factor
            elif f.kind == "tile_down":
                self.dead_tiles.add(tuple(f.tile))
        return fired

    def step_time(self, host: int, base: float) -> float:
        return base * self.slow_hosts.get(host, 1.0)

    def alive(self, num_hosts: int) -> list[int]:
        return [h for h in range(num_hosts) if h not in self.down_hosts]


def tile_row_failures(step: int, row: int, ti: int) -> list[Failure]:
    """A whole physical tile row dying at once, as per-tile ``tile_down``
    failures."""
    return [Failure(step=step, kind="tile_down", tile=(row, i))
            for i in range(ti)]
