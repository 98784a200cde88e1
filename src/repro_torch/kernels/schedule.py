"""Static kernel schedules for arbitrary adjacent-pair mesh layouts.

A kernel column pairs channels in one of two ways:

  * parity 0 — ``(2i, 2i+1)``: pair slot ``i`` rotates channels 2i, 2i+1;
  * parity 1 — ``(2i+1, 2i+2)``: slot ``i`` rotates channels 2i+1, 2i+2
    (the last slot ``P-1`` never holds a cell).

A :class:`repro_torch.core.mesh.MeshPlan` column, however, may mix both
parities (``pack_cells_to_columns`` packs greedily).
:func:`schedule_from_plan` re-schedules any plan into parity-homogeneous
kernel columns: each plan column splits into at most one parity-0 and one
parity-1 sub-column (exact, because cells within a plan column never
overlap and therefore commute).  The rectangular Clements layout maps 1:1.

:class:`MeshSchedule` is hashable and purely static (tuples of ints);
:func:`pack_cells` gathers per-cell 2x2 transfer matrices (ideal *or*
hardware-imperfect) into the kernels' ``[C', 8, P]`` coefficient layout.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class MeshSchedule:
    """Parity-homogeneous column schedule of an adjacent-pair mesh.

    Attributes:
      n: number of channels (even).
      parity: per kernel column, 0 (pairs ``(2i, 2i+1)``) or 1
        (pairs ``(2i+1, 2i+2)``).
      source: per kernel column, ``n//2`` entries mapping each kernel pair
        slot to a flat plan-cell index ``col * P + slot`` (or -1 for an
        identity slot).
    """

    n: int
    parity: tuple[int, ...]
    source: tuple[tuple[int, ...], ...]

    @property
    def n_columns(self) -> int:
        return len(self.parity)

    @property
    def pairs(self) -> int:
        return self.n // 2


@functools.lru_cache(maxsize=128)
def schedule_from_plan(plan: mesh_lib.MeshPlan) -> MeshSchedule:
    """Re-schedule an arbitrary MeshPlan into kernel parity columns."""
    pk = plan.n // 2
    parity: list[int] = []
    source: list[tuple[int, ...]] = []
    for c in range(plan.n_columns):
        for par in (0, 1):
            row = [-1] * pk
            found = False
            for s in range(plan.pairs_per_column):
                if not plan.active[c, s]:
                    continue
                p = int(plan.top[c, s])
                if p % 2 != par:
                    continue
                row[p // 2] = c * plan.pairs_per_column + s
                found = True
            if found:
                parity.append(par)
                source.append(tuple(row))
    if not parity:  # cell-free mesh: one identity column keeps shapes valid
        parity = [0]
        source = [tuple([-1] * pk)]
    return MeshSchedule(n=plan.n, parity=tuple(parity), source=tuple(source))


def clements_schedule(n: int) -> MeshSchedule:
    """The rectangular Clements schedule (1:1 with its plan columns)."""
    return schedule_from_plan(mesh_lib.clements_plan(n))


@functools.lru_cache(maxsize=256)
def _parity_on(sched: MeshSchedule, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(sched.parity, dtype=torch.int32, device=device)


def parity_array(sched: MeshSchedule, device=None) -> torch.Tensor:
    """The per-column parity as the kernel's ``[C']`` int32 input.

    Memoized per (schedule, device): steady-state calls copy nothing to the
    card.  Callers must not write into the returned tensor.
    """
    return _parity_on(sched, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=256)
def _pack_indices(sched: MeshSchedule, c: int, p: int,
                  device: torch.device) -> torch.Tensor:
    """Gather map for :func:`pack_cells`: flat plan-cell index per kernel
    slot, with -1 redirected to the appended identity cell at ``c * p``."""
    idx = np.asarray(sched.source, np.int64)
    return torch.as_tensor(np.where(idx < 0, c * p, idx), device=device)


def pack_cells(sched: MeshSchedule, t_all: torch.Tensor) -> torch.Tensor:
    """Gather per-cell 2x2 matrices into kernel coefficients ``[C', 8, P]``.

    ``t_all``: complex ``[..., C, P, 2, 2]`` cell transfer matrices in plan
    layout.  Inactive plan slots are never referenced by the schedule, so
    parked parameters cannot leak in; identity fills the unused kernel
    slots.  Differentiable (a gather), and leading batch dims carry through.
    Rows per slot: (t00, t01, t10, t11) x (re, im).
    """
    c, p = t_all.shape[-4], t_all.shape[-3]
    if p != sched.pairs:
        raise ValueError(
            f"cell tensor has {p} pair slots per column, schedule expects "
            f"{sched.pairs} (n={sched.n})")
    max_src = max((s for row in sched.source for s in row), default=-1)
    if max_src >= c * p:
        raise ValueError(
            f"schedule references cell {max_src} but tensor holds only "
            f"{c * p} — t_all built from a different plan?")
    lead = t_all.shape[:-4]
    flat = t_all.reshape(lead + (c * p, 2, 2)).to(torch.complex64)
    eye = torch.eye(2, dtype=torch.complex64, device=flat.device)
    flat = torch.cat([flat, eye.expand(lead + (1, 2, 2))], dim=-3)
    idx = _pack_indices(sched, c, p, flat.device)   # [C', P]
    cells = flat[..., idx, :, :]                    # [..., C', P, 2, 2]
    coef = torch.view_as_real(cells.reshape(cells.shape[:-2] + (4,)))
    # [..., C', P, 4, 2] -> [..., C', 8, P]
    coef = coef.reshape(cells.shape[:-2] + (8,)).movedim(-1, -2)
    return coef.to(torch.float32).contiguous()
