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


# ---------------------------------------------------------------------------
# the deep tile grid: L layers of (To x Ti) tiles (kernels B6-B8)
# ---------------------------------------------------------------------------

#: Coefficient rows of an identity 2x2 cell (t00 = t11 = 1): the padding
#: column appended to short meshes so every mesh of a grid shares one
#: column count.
_IDENTITY_ROWS = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class DeepGridSchedule:
    """Static schedule of an L-layer network of (To x Ti) tile grids.

    ``layers[l][o][i]`` is the ``(V, U)`` pair of :class:`MeshSchedule`\\ s
    of tile ``(o, i)`` in layer ``l``.  The deep kernels run the whole
    network in one launch per direction, with coefficients, parities and
    gains stacked to ``[L, To, Ti, C, 8, P]``, ``[L, To, Ti, C]`` and
    ``[L, To, Ti, 12, P]``, where ``C = n_columns`` is the largest column
    count of any mesh in the network (shorter meshes pad with identity
    columns, exact no-ops in the sweep).  Between layers the kernel
    re-detects the combined rows, so layer ``l``'s ``To`` rows feed layer
    ``l + 1``'s ``Ti`` input tiles: ``To == Ti`` whenever ``L > 1``.
    Hashable and purely static, like :class:`MeshSchedule`.
    """

    layers: tuple[tuple[tuple[tuple[MeshSchedule, MeshSchedule], ...],
                        ...], ...]

    def __post_init__(self):
        if not self.layers:
            raise ValueError("deep grid schedule needs at least one layer")
        to = len(self.layers[0])
        if not to or not self.layers[0][0]:
            raise ValueError("deep grid needs at least one tile")
        ti = len(self.layers[0][0])
        n = self.layers[0][0][0][0].n
        for grid in self.layers:
            if len(grid) != to or any(len(row) != ti for row in grid):
                raise ValueError(
                    "every layer's tile grid must be the same rectangular "
                    f"{to}x{ti} shape")
            for row in grid:
                for sv, su in row:
                    if sv.n != n or su.n != n:
                        raise ValueError(
                            f"all tile meshes must share n={n}, got "
                            f"({sv.n}, {su.n})")
        if len(self.layers) > 1 and to != ti:
            raise ValueError(
                f"a deep ({len(self.layers)}-layer) grid chains each "
                f"layer's To={to} row outputs into the next layer's "
                f"Ti={ti} input tiles, so To must equal Ti")

    @property
    def n(self) -> int:
        return self.layers[0][0][0][0].n

    @property
    def pairs(self) -> int:
        return self.n // 2

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def to(self) -> int:
        return len(self.layers[0])

    @property
    def ti(self) -> int:
        return len(self.layers[0][0])

    @property
    def n_columns(self) -> int:
        return max(max(sv.n_columns, su.n_columns)
                   for grid in self.layers for row in grid for sv, su in row)

    def layer(self, l: int) -> "DeepGridSchedule":
        """The single-layer (1 x To x Ti) schedule of layer ``l``."""
        return DeepGridSchedule(layers=(self.layers[l],))


def _mesh_pair(pair, n: int) -> tuple[MeshSchedule, MeshSchedule]:
    v_plan, u_plan = (None, None) if pair is None else pair
    return (clements_schedule(n) if v_plan is None
            else schedule_from_plan(v_plan),
            clements_schedule(n) if u_plan is None
            else schedule_from_plan(u_plan))


def deep_grid_schedule(n: int, depth: int, to: int, ti: int,
                       plans=None) -> DeepGridSchedule:
    """Build a DeepGridSchedule: ``depth`` layers of (to x ti) tile grids.

    ``plans``: optional ``[depth][to][ti]`` nested sequence of per-tile
    ``(v_plan, u_plan)`` pairs (``None`` entries, and ``None`` layers, fall
    back to the Clements rectangle); ``None`` uses Clements everywhere.
    """
    if plans is None:
        plans = (None,) * depth
    if len(plans) != depth:
        raise ValueError(f"{len(plans)} plan grids for depth {depth}")
    layers = []
    for lgrid in plans:
        if lgrid is None:
            lgrid = ((None,) * ti,) * to
        if len(lgrid) != to or any(len(row) != ti for row in lgrid):
            raise ValueError(f"each layer's plans grid must be {to}x{ti}")
        layers.append(tuple(tuple(_mesh_pair(pair, n) for pair in prow)
                            for prow in lgrid))
    return DeepGridSchedule(layers=tuple(layers))


@functools.lru_cache(maxsize=64)
def _deep_parity_on(deep: DeepGridSchedule, device: torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (deep.n_layers, deep.to, deep.ti, deep.n_columns)
    pv, pu = np.zeros(shape, np.int32), np.zeros(shape, np.int32)
    for l, grid in enumerate(deep.layers):
        for o, row in enumerate(grid):
            for i, (sv, su) in enumerate(row):
                pv[l, o, i, : sv.n_columns] = sv.parity
                pu[l, o, i, : su.n_columns] = su.parity
    return (torch.as_tensor(pv, device=device),
            torch.as_tensor(pu, device=device))


def deep_grid_parity_arrays(deep: DeepGridSchedule, device=None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The V and U parities as the deep kernels' ``[L, To, Ti, C]`` int32
    inputs.  Identity-padded columns get parity 0 (their cells are the
    identity, so the pairing is irrelevant).  Memoized per (schedule,
    device), keyed by content; callers must not write into them."""
    return _deep_parity_on(deep, torch.device(device or "cpu"))


@dataclasses.dataclass(frozen=True)
class NetworkSchedule:
    """Static schedule of an L-layer RFNN: per layer a ``(V, U)`` pair of
    :class:`MeshSchedule`\\ s over one channel count.  The deep kernels run
    it as the ``L x 1 x 1`` grid :attr:`deep`."""

    layers: tuple[tuple[MeshSchedule, MeshSchedule], ...]

    def __post_init__(self):
        if not self.layers:
            raise ValueError("network schedule needs at least one layer")
        n = self.layers[0][0].n
        for sv, su in self.layers:
            if sv.n != n or su.n != n:
                raise ValueError(
                    f"all layer meshes must share n={n}, got "
                    f"{[(sv.n, su.n) for sv, su in self.layers]}")

    @property
    def n(self) -> int:
        return self.layers[0][0].n

    @property
    def pairs(self) -> int:
        return self.n // 2

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def n_columns(self) -> int:
        return max(max(sv.n_columns, su.n_columns) for sv, su in self.layers)

    @property
    def deep(self) -> DeepGridSchedule:
        """The equivalent ``L x 1 x 1`` :class:`DeepGridSchedule`."""
        return DeepGridSchedule(
            layers=tuple((((sv, su),),) for sv, su in self.layers))


def network_schedule(n: int, depth: int, plans=None) -> NetworkSchedule:
    """Build a NetworkSchedule for ``depth`` layers of n-channel meshes;
    ``plans``: optional per-layer ``(v_plan, u_plan)`` pairs (``None``
    entries fall back to the Clements rectangle)."""
    if plans is None:
        plans = (None,) * depth
    if len(plans) != depth:
        raise ValueError(f"{len(plans)} plan pairs for depth {depth}")
    return NetworkSchedule(layers=tuple(_mesh_pair(p, n) for p in plans))


@dataclasses.dataclass(frozen=True)
class TileGridSchedule:
    """Static schedule of one (To x Ti) grid of analog tile processors:
    per tile a ``(V, U)`` pair of :class:`MeshSchedule`\\ s realizing one
    ``n x n`` block of a ``(To n) x (Ti n)`` matrix.  The deep kernels run
    it as the ``1 x To x Ti`` grid :attr:`deep`."""

    tiles: tuple[tuple[tuple[MeshSchedule, MeshSchedule], ...], ...]

    def __post_init__(self):
        DeepGridSchedule(layers=(self.tiles,))  # the same validation

    @property
    def n(self) -> int:
        return self.tiles[0][0][0].n

    @property
    def pairs(self) -> int:
        return self.n // 2

    @property
    def to(self) -> int:
        return len(self.tiles)

    @property
    def ti(self) -> int:
        return len(self.tiles[0])

    @property
    def n_columns(self) -> int:
        return self.deep.n_columns

    @property
    def deep(self) -> DeepGridSchedule:
        """The equivalent ``1 x To x Ti`` :class:`DeepGridSchedule`."""
        return DeepGridSchedule(layers=(self.tiles,))


def tile_grid_schedule(n: int, to: int, ti: int,
                       plans=None) -> TileGridSchedule:
    """Build a TileGridSchedule for a (to x ti) grid of n-channel tiles;
    ``plans``: optional ``[to][ti]`` nesting of ``(v_plan, u_plan)`` pairs
    (``None`` entries fall back to the Clements rectangle)."""
    return TileGridSchedule(
        tiles=deep_grid_schedule(n, 1, to, ti, (plans,)).layers[0])


def pad_columns(coef: torch.Tensor, n_columns: int) -> torch.Tensor:
    """Pad ``[..., C, 8, P]`` coefficients to ``n_columns`` with identity
    cells (exact no-op columns in the sweep).  Differentiable."""
    c = coef.shape[-3]
    if c > n_columns:
        raise ValueError(f"coefficients have {c} columns > pad {n_columns}")
    if c == n_columns:
        return coef
    rows = torch.tensor(_IDENTITY_ROWS, dtype=coef.dtype,
                        device=coef.device)[:, None]          # [8, 1]
    ident = rows.expand(coef.shape[:-3] + (n_columns - c, 8, coef.shape[-1]))
    return torch.cat([coef, ident], dim=-3)
