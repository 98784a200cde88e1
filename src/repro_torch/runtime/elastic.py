"""Elastic recovery planning: the counterpart of the JAX package's
``repro.runtime.elastic``, pure data and numpy.

**Chip-level planner** (``RecoveryPlan``, ``plan_recovery``,
``hosts_to_chips``).  Given the surviving chip count, choose the largest
valid (pod, data, model) mesh and the config adjustments needed to resume:

  * losing a full pod: 512 -> 256 drops the "pod" axis (DP halves,
    grad-accum doubles to keep the global batch);
  * losing k hosts inside a pod: the data axis shrinks to the largest
    divisor the surviving hosts tile, the model axis kept at its width;
  * below a floor, the plan reports non-viable for operator intervention.

Its constants are the reference's fleet, not this card's: ``HOST_CHIPS``
(4 chips a host) and ``MODEL_AXIS`` (a tensor-parallel degree of 16, fixed
by the reference's inter-chip ring), with a 512-chip original fleet.  The
training driver (``repro_torch.launch.train``) prints the plan when the
straggler monitor drops a host, as the JAX package's driver does; neither
rebuilds a mesh from it.

**Analog tile-grid recovery** (``TileRecoveryPlan``,
``plan_tile_recovery``): remap a (To x Ti) grid around dead tiles.  A dead
tile (or a whole dead tile row) cannot shrink the kernel grid, since
the matrix still needs every logical block, but the row x column
permutation freedom of the block decomposition (``compile/placement.py``)
can park the least important logical tiles on the dead positions, where
their contribution is blanked.  The plan is pure data: the caller applies
it with ``repro_torch.compile.recover_tiled`` (re-place, blank,
re-calibrate exactly the moved tiles, re-lower).
"""

from __future__ import annotations

import dataclasses

import numpy as np


#: the reference fleet's chips a host (not this card's)
HOST_CHIPS = 4
#: the reference fleet's tensor-parallel degree, fixed by its inter-chip ring
MODEL_AXIS = 16


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    dp_shards: int
    accum_multiplier: int      # scale grad-accum to preserve global batch
    dropped_chips: int
    viable: bool
    reason: str = ""

    @property
    def chips(self) -> int:
        n = 1
        for s in self.mesh_shape:
            n *= s
        return n


def plan_recovery(surviving_chips: int, *, original_chips: int = 512,
                  min_data: int = 4,
                  model_axis: int = MODEL_AXIS) -> RecoveryPlan:
    """Largest valid (pod, data, model) mesh within the surviving fleet.

    ``model_axis`` is the fixed tensor-parallel degree (default the
    reference's 16).
    """
    if surviving_chips >= original_chips:
        pods = original_chips // (16 * model_axis)
        return RecoveryPlan((pods, 16, model_axis),
                            ("pod", "data", "model"), pods * 16, 1,
                            surviving_chips - original_chips, True)
    # single-pod meshes with a shrinking data axis
    full_dp = original_chips // model_axis
    for data in (16, 12, 8, 6, 4):
        chips = data * model_axis
        if chips <= surviving_chips and data >= min_data:
            accum = max(1, full_dp // data)  # preserve the global batch
            return RecoveryPlan((data, model_axis), ("data", "model"), data,
                                accum, surviving_chips - chips, True)
    return RecoveryPlan((), (), 0, 0, surviving_chips, False,
                        reason=f"only {surviving_chips} chips alive; "
                               f"need >= {min_data * model_axis}")


def hosts_to_chips(surviving_hosts: int, *,
                   host_chips: int = HOST_CHIPS) -> int:
    return surviving_hosts * host_chips



@dataclasses.dataclass(frozen=True)
class TileRecoveryPlan:
    grid_shape: tuple[int, int]            # (To, Ti): kernel grid unchanged
    row_perm: tuple[int, ...]              # physical row -> logical row
    col_perm: tuple[int, ...]              # physical col -> logical col
    dead: tuple[tuple[int, int], ...]      # physical positions out of service
    recalibrate: tuple[tuple[int, int], ...]  # live positions needing re-trim
    dropped_mass: float                    # sensitivity fraction parked dead
    viable: bool
    reason: str = ""


def plan_tile_recovery(sensitivity, dead_tiles, *,
                       row_perm=None, col_perm=None,
                       max_dropped_mass: float = 0.05) -> TileRecoveryPlan:
    """Remap a degraded (To x Ti) tile grid around its dead positions.

    ``sensitivity``: ``[To, Ti]`` logical singular-value mass
    (``repro_torch.compile.tile_sensitivities``).  ``dead_tiles``: physical
    ``(po, pi)`` positions out of service.  ``row_perm``/``col_perm``: the
    grid's current placement (identity when unplaced).

    The new permutation greedily parks low-mass logical rows/columns on the
    physical rows/columns with the most dead cells (stable sorts, so an
    undamaged axis keeps its current assignment).  Viability is an
    accuracy floor: the sensitivity mass parked on dead positions must stay
    within ``max_dropped_mass`` of the total; above it the plan reports
    non-viable.  ``recalibrate`` lists the *live* positions whose hosted
    logical tile changed: exactly those re-trim against their new
    positions' hardware draws.
    """
    sens = np.asarray(sensitivity, np.float64)
    to, ti = sens.shape
    dead = {(int(o), int(i)) for o, i in dead_tiles}
    for o, i in dead:
        if not (0 <= o < to and 0 <= i < ti):
            raise ValueError(f"dead tile {(o, i)} outside {to}x{ti} grid")
    old_r = tuple(row_perm) if row_perm is not None else tuple(range(to))
    old_c = tuple(col_perm) if col_perm is not None else tuple(range(ti))

    # dead-cell counts per physical row/column drive the matching: the most
    # damaged physical rows get the least sensitive logical rows
    dead_rows = np.zeros(to)
    dead_cols = np.zeros(ti)
    for o, i in dead:
        dead_rows[o] += 1.0
        dead_cols[i] += 1.0

    def match(damage, mass, old):
        # uniformly damaged (or undamaged) axis: re-permuting cannot move
        # mass off dead cells, so keep the placement (zero recalibrations)
        if damage.max() == damage.min():
            return old
        phys = np.argsort(-damage, kind="stable")   # most damaged first
        logi = np.argsort(mass, kind="stable")      # least mass first
        perm = np.empty(len(phys), np.int64)
        perm[phys] = logi
        return tuple(int(v) for v in perm)

    new_r = match(dead_rows, sens.sum(1), old_r)
    new_c = match(dead_cols, sens.sum(0), old_c)

    total = float(sens.sum())
    dropped = sum(float(sens[new_r[o], new_c[i]]) for o, i in dead)
    frac = dropped / total if total > 0 else 0.0
    moved = tuple(sorted(
        (po, pi)
        for po in range(to) for pi in range(ti)
        if (po, pi) not in dead
        and (new_r[po], new_c[pi]) != (old_r[po], old_c[pi])))
    viable = frac <= max_dropped_mass
    return TileRecoveryPlan(
        grid_shape=(to, ti), row_perm=new_r, col_perm=new_c,
        dead=tuple(sorted(dead)), recalibrate=moved,
        dropped_mass=frac, viable=viable,
        reason="" if viable else (
            f"remap still parks {frac:.1%} of the sensitivity mass on "
            f"dead tiles (floor {max_dropped_mass:.1%})"))
