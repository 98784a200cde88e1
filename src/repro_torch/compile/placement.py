"""Yield-aware tile placement: map logical tiles onto physical positions.
The counterpart of the JAX package's ``repro.compile.placement``.

The paper's Sec. V scale-up composes one large matrix from a grid of small
physical processors; fabrication spread (Sec. III) makes those positions
*unequal*: each physical position freezes its own phase-noise draw at
``calibrate_tiled`` time.  Any permutation of logical tile rows and columns
can be realized by permuting which physical position hosts which logical
block and permuting the digital input/output tile streams to match, so
placement puts the *high-sensitivity* logical tiles (largest singular-value
mass) on the *high-yield* physical positions, and the near-zero blocks on
the lemons.

* :func:`apply_placement` physically reorders the grid (so every physical
  position calibrates against its own draw) and records the
  :class:`TilePlacement` on the program;
* :class:`~repro_torch.compile.program.CompiledTiledProgram` undoes it in
  ``apply`` as index gathers on the input/output tile axes (the kernel and
  its schedule are untouched);
* :func:`recover_tiled` re-places a grid around dead positions from a
  :class:`~repro_torch.runtime.elastic.TileRecoveryPlan`, blanks the dead
  positions and re-calibrates exactly the tiles whose position changed.

Placement is restricted to row x column permutations because the kernel's
row combine fixes which input tiles feed which output row.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compile.program import TiledAnalogProgram
from repro_torch.core import hardware as hw_lib
from repro_torch.core import mesh as mesh_lib
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class TilePlacement:
    """A logical -> physical row x column permutation of the tile grid.

    Physical position ``(po, pi)`` hosts logical tile
    ``(row_perm[po], col_perm[pi])``.  Both perms are permutations of
    ``range(To)`` / ``range(Ti)``; the identity placement is a no-op
    everywhere (``apply`` skips the gathers entirely).
    """

    row_perm: tuple[int, ...]
    col_perm: tuple[int, ...]

    def __post_init__(self):
        for name, perm in (("row_perm", self.row_perm),
                           ("col_perm", self.col_perm)):
            if sorted(perm) != list(range(len(perm))):
                raise ValueError(f"{name} is not a permutation: {perm}")

    @classmethod
    def identity(cls, to: int, ti: int) -> "TilePlacement":
        return cls(tuple(range(to)), tuple(range(ti)))

    @property
    def is_identity(self) -> bool:
        return (self.row_perm == tuple(range(len(self.row_perm)))
                and self.col_perm == tuple(range(len(self.col_perm))))

    @property
    def inv_row_perm(self) -> tuple[int, ...]:
        """``inv[r]`` = the physical row hosting logical row ``r``."""
        inv = [0] * len(self.row_perm)
        for po, r in enumerate(self.row_perm):
            inv[r] = po
        return tuple(inv)

    @property
    def inv_col_perm(self) -> tuple[int, ...]:
        inv = [0] * len(self.col_perm)
        for pi, c in enumerate(self.col_perm):
            inv[c] = pi
        return tuple(inv)


def tile_sensitivities(tp: TiledAnalogProgram) -> np.ndarray:
    """``[To, Ti]`` singular-value mass per logical tile.

    ``scale * sum(attenuation)`` is the tile's total singular-value mass
    (sigma_max times the normalized diagonal).  Zero-padding blocks score 0
    and gravitate to the worst (or dead) positions.
    """
    s = np.zeros((tp.to, tp.ti), np.float64)
    for o, row in enumerate(tp.grid):
        for i, la in enumerate(row):
            s[o, i] = float(la.scale) * float(la.attenuation.sum())
    return s


def position_yield_scores(to: int, ti: int,
                          hardware: hw_lib.HardwareModel, *,
                          key: int | None = None, tile: int, seed: int = 0,
                          probe_params=None, draws=None,
                          device=None) -> np.ndarray:
    """``[To, Ti]`` yield score of every physical grid position.

    Probes each position with the same fixed V/D/U tile (Clements meshes of
    ``tile`` channels, phases from a CPU generator seeded ``seed``, or the
    ``(params_v, params_u)`` pair ``probe_params``) under the phase-noise
    draw that position freezes at ``calibrate_tiled`` time:
    :func:`~repro_torch.core.hardware.frozen_draws` of ``(key, position =
    o * Ti + i, layer 0)``, or ``draws[o][i]`` (a ``(draws_v, draws_u)``
    pair) when given, so the score ranks the draws calibration binds.  The
    metric is the relative L2 error of the detected output against the
    ideal device after the optimal scalar (digital gamma) compensation,
    negated so higher is better.  Runs on ``device`` (CUDA when None): two
    ``ops.mesh_apply`` probes per position (kernel B1 on the card).
    """
    if (key is None) == (draws is None):
        raise ValueError("pass exactly one of key= and draws=")
    device = resolve_device(device)
    plan = mesh_lib.clements_plan(tile)
    if probe_params is None:
        gen = torch.Generator().manual_seed(seed)
        probe_params = tuple(mesh_lib.init_mesh_params(
            gen, plan, with_sigma=False, device=device) for _ in range(2))
    params_v, params_u = probe_params
    probes = torch.eye(tile, dtype=torch.complex64, device=device)

    def chain(dv, du, hw):
        h = kernel_ops.mesh_apply(params_v, probes, n=tile, plan=plan,
                                  hardware=hw, draws=dv)
        h = kernel_ops.mesh_apply(params_u, h, n=tile, plan=plan,
                                  hardware=hw, draws=du)
        return h.abs()

    errors = np.zeros((to, ti), np.float64)
    with torch.no_grad():
        y_ideal = chain(None, None, None)
        for o in range(to):
            for i in range(ti):
                if draws is not None:
                    dv, du = draws[o][i]
                else:
                    dv, du = hw_lib.frozen_draws(
                        key, (params_v, params_u), layer=0,
                        position=o * ti + i)
                mag = chain(dv, du, hardware)
                gamma = ((mag * y_ideal).sum()
                         / torch.clamp_min((mag * mag).sum(), 1e-12))
                err = (torch.linalg.norm(gamma * mag - y_ideal)
                       / torch.clamp_min(torch.linalg.norm(y_ideal), 1e-12))
                errors[o, i] = float(err)
    return -errors


def plan_placement(sensitivity: np.ndarray,
                   scores: np.ndarray) -> TilePlacement:
    """Match high-sensitivity logical tiles to high-yield positions.

    Works on the row/column marginals (the only degrees of freedom a
    row x column permutation has): the most sensitive logical row is
    assigned to the best-scoring physical row, and likewise for columns.
    Sorting is stable, so equal-mass rows keep their logical order and a
    uniform grid yields the identity placement.
    """
    sens = np.asarray(sensitivity, np.float64)
    sc = np.asarray(scores, np.float64)
    if sens.shape != sc.shape:
        raise ValueError(f"shape mismatch: sensitivity {sens.shape} vs "
                         f"scores {sc.shape}")

    def match(sens_m, score_m):
        phys = np.argsort(-score_m, kind="stable")   # best position first
        logi = np.argsort(-sens_m, kind="stable")    # most sensitive first
        perm = np.empty(len(phys), np.int64)
        perm[phys] = logi
        return tuple(int(v) for v in perm)

    return TilePlacement(row_perm=match(sens.sum(1), sc.sum(1)),
                         col_perm=match(sens.sum(0), sc.sum(0)))


def apply_placement(tp: TiledAnalogProgram,
                    placement: TilePlacement) -> TiledAnalogProgram:
    """Physically reorder the grid so position ``(po, pi)`` holds logical
    tile ``(row_perm[po], col_perm[pi])``, recording the placement.

    Run *before* ``calibrate_tiled``: the moved tiles then calibrate
    against the draws of the positions they occupy.  Raises if the program
    already carries a placement (compose via :func:`undo_placement`).
    """
    if tp.placement is not None and not tp.placement.is_identity:
        raise ValueError("program already carries a placement — "
                         "undo_placement first")
    if (len(placement.row_perm), len(placement.col_perm)) != (tp.to, tp.ti):
        raise ValueError(
            f"placement is {len(placement.row_perm)}x"
            f"{len(placement.col_perm)} for a {tp.to}x{tp.ti} grid")
    grid = tuple(
        tuple(tp.grid[placement.row_perm[po]][placement.col_perm[pi]]
              for pi in range(tp.ti))
        for po in range(tp.to))
    return dataclasses.replace(tp, grid=grid, placement=placement)


def undo_placement(tp: TiledAnalogProgram) -> TiledAnalogProgram:
    """Back to logical order (tile state, calibration included, rides along
    with each tile)."""
    pl = tp.placement
    if pl is None or pl.is_identity:
        return dataclasses.replace(tp, placement=None)
    inv_r, inv_c = pl.inv_row_perm, pl.inv_col_perm
    grid = tuple(
        tuple(tp.grid[inv_r[o]][inv_c[i]] for i in range(tp.ti))
        for o in range(tp.to))
    return dataclasses.replace(tp, grid=grid, placement=None)


def blank_tile(la, *, scale_zero: float = 0.0):
    """A dead tile's program: zero digital gamma (an unpowered passive tile
    contributes nothing to its row's combine)."""
    return la.replace(scale=torch.tensor(scale_zero, dtype=torch.float32,
                                         device=la.device))


def recover_tiled(tp: TiledAnalogProgram, plan,
                  hardware: hw_lib.HardwareModel | None = None, *,
                  key: int | None = None, draws=None, lower: bool = True,
                  **calibrate_kw):
    """Rebuild a placed and calibrated grid around dead positions.

    ``plan`` is a :class:`repro_torch.runtime.elastic.TileRecoveryPlan`:
    its permutations park the least-sensitive logical tiles on the dead
    positions, which are then blanked; the surviving tiles whose physical
    position changed re-``calibrate`` against their new positions' draws
    (``plan.recalibrate``; ``key``/``draws`` as in ``calibrate_tiled``),
    every other tile keeps its binding untouched.  Returns the recompiled
    :class:`~repro_torch.compile.program.CompiledTiledProgram` (or the
    recovered :class:`TiledAnalogProgram` with ``lower=False``).
    """
    from repro_torch.compile import passes

    if not plan.viable:
        raise ValueError(f"recovery plan is not viable: {plan.reason}")
    logical = undo_placement(tp)
    placed = apply_placement(
        logical, TilePlacement(plan.row_perm, plan.col_perm))
    dead = set(plan.dead)
    placed = placed.map_tiles(
        lambda o, i, la: blank_tile(la) if (o, i) in dead else la)
    if plan.recalibrate:
        placed = passes.calibrate_tiled(placed, hardware, key=key,
                                        draws=draws, only=plan.recalibrate,
                                        **calibrate_kw)
    if not lower:
        return placed
    return passes.lower_tiled(placed)
