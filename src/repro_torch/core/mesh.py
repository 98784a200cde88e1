"""N-channel meshes of 2x2 RF analog processor cells (paper Sec. IV-B, Fig. 13).

A mesh is a sequence of *columns*; each column applies a set of
non-overlapping 2x2 cells to adjacent channel pairs ``(p, p+1)``.  An N x N
unitary needs S = N(N-1)/2 cells (paper Eq. 28) plus a diagonal phase screen
``Sigma(N)`` (Eq. 27).

``clements`` is the rectangular layout: N columns alternating pair offsets
0/1, depth N — the layout of the paper's MNIST network, whose 8x8 mesh
phases are trained directly.  ``pack_cells_to_columns`` schedules any
ordered cell list into columns (which may then mix both pair offsets).

The forward apply here is the reference column scan (a Python loop over
columns, each update scatter-free through per-channel role/slot maps); the
kernel path is :func:`repro_torch.kernels.ops.mesh_apply`.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.cell import as_complex, cell_matrix, cmatmul, expj

_ROLE_NONE, _ROLE_TOP, _ROLE_BOT = 0, 1, 2


# ---------------------------------------------------------------------------
# Mesh plan (static layout metadata)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class MeshPlan:
    """Static layout of a cell mesh.

    Hashable *by content* (``n`` + the top/active layout bytes; slot/role
    are derived), so two independently constructed but identical plans hit
    the same memoized schedules.

    Attributes:
      n: number of channels (even).
      top: int32 [C, P] — top channel index of each pair slot per column.
      active: bool [C, P] — whether the slot holds a real cell.
      slot: int32 [C, n] — pair slot feeding each channel (0 when none).
      role: int8 [C, n] — 0 untouched / 1 top of pair / 2 bottom of pair.
    """

    n: int
    top: np.ndarray
    active: np.ndarray
    slot: np.ndarray
    role: np.ndarray

    def _key(self) -> tuple:
        return (self.n, self.top.shape,
                self.top.tobytes(), self.active.tobytes())

    def __eq__(self, other):
        if not isinstance(other, MeshPlan):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    @property
    def n_columns(self) -> int:
        return self.top.shape[0]

    @property
    def pairs_per_column(self) -> int:
        return self.top.shape[1]

    @property
    def n_cells(self) -> int:
        return int(self.active.sum())

    def param_shape(self) -> tuple[int, int]:
        """Shape of the theta/phi parameter arrays."""
        return (self.n_columns, self.pairs_per_column)


def _make_plan(n: int, top: np.ndarray, active: np.ndarray) -> MeshPlan:
    """Derive the per-channel role/slot maps and build the plan."""
    c, _ = top.shape
    slot = np.zeros((c, n), np.int32)
    role = np.zeros((c, n), np.int8)
    for ci in range(c):
        for si in range(top.shape[1]):
            if not active[ci, si]:
                continue
            p = int(top[ci, si])
            if p < 0 or p + 1 >= n:
                raise ValueError(f"pair ({p},{p+1}) out of range for n={n}")
            if role[ci, p] != _ROLE_NONE or role[ci, p + 1] != _ROLE_NONE:
                raise ValueError(f"overlapping pairs in column {ci}")
            slot[ci, p] = si
            role[ci, p] = _ROLE_TOP
            slot[ci, p + 1] = si
            role[ci, p + 1] = _ROLE_BOT
    return MeshPlan(n=n, top=top, active=active, slot=slot, role=role)


@functools.lru_cache(maxsize=64)
def clements_plan(n: int) -> MeshPlan:
    """Rectangular mesh: N columns, alternating offsets; N(N-1)/2 cells."""
    if n < 2 or n % 2:
        raise ValueError(f"mesh size must be even and >= 2, got {n}")
    p = n // 2
    top = np.zeros((n, p), np.int32)
    active = np.zeros((n, p), bool)
    for c in range(n):
        starts = np.arange(c % 2, n - 1, 2)
        top[c, : len(starts)] = starts
        active[c, : len(starts)] = True
    plan = _make_plan(n, top, active)
    if plan.n_cells != n * (n - 1) // 2:
        raise AssertionError("Clements layout lost cells")
    return plan


def pack_cells_to_columns(n: int, cells: list[tuple[int, float, float]],
                          pad_to_columns: int | None = None, device=None):
    """Greedy list-schedule of an ordered cell sequence into mesh columns.

    ``cells`` is a list of ``(p, theta, phi)`` applied in order (cell i acts
    before cell j for i < j when they share a channel).  Returns
    ``(MeshPlan, theta[C,P], phi[C,P])`` with float32 tensors on ``device``
    (CPU when None).  ``pad_to_columns`` appends empty columns for shape
    stability across programs of the same size.
    """
    if n % 2:
        raise ValueError("mesh size must be even")
    free = np.zeros(n, np.int64)  # earliest column each channel is free at
    placed: list[list[tuple[int, float, float]]] = [[]]
    for p, th, ph in cells:
        col = int(max(free[p], free[p + 1]))
        while len(placed) <= col:
            placed.append([])
        placed[col].append((p, th, ph))
        free[p] = free[p + 1] = col + 1
    n_cols = len(placed)
    if pad_to_columns is not None:
        if n_cols > pad_to_columns:
            raise ValueError(f"packed {n_cols} columns > pad {pad_to_columns}")
        n_cols = pad_to_columns
    pmax = n // 2
    top = np.zeros((n_cols, pmax), np.int32)
    active = np.zeros((n_cols, pmax), bool)
    theta = np.zeros((n_cols, pmax), np.float32)
    phi = np.zeros((n_cols, pmax), np.float32)
    for c, col_cells in enumerate(placed):
        for k, (p, th, ph) in enumerate(sorted(col_cells)):
            top[c, k] = p
            active[c, k] = True
            theta[c, k] = th
            phi[c, k] = ph
    return (_make_plan(n, top, active),
            torch.as_tensor(theta, device=device),
            torch.as_tensor(phi, device=device))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_mesh_params(generator: torch.Generator, plan: MeshPlan, *,
                     with_sigma: bool = True, device=None) -> dict:
    """Random mesh parameters: dict of theta, phi [C, P] and alpha [n].

    Drawn from ``generator`` (a CPU generator) on the CPU and then moved to
    ``device``, so one seed gives the same parameters on every device.
    """
    c, p = plan.param_shape()

    def uniform(shape, hi):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (u * hi).to(device)

    params = {"theta": uniform((c, p), math.pi),
              "phi": uniform((c, p), 2 * math.pi)}
    if with_sigma:
        params["alpha"] = uniform((plan.n,), 2 * math.pi)
    return params


# ---------------------------------------------------------------------------
# Forward application (the reference column scan)
# ---------------------------------------------------------------------------

def _plan_tensors(plan: MeshPlan, device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, dtype=torch.long, device=device)
                 for a in (plan.top, plan.slot, plan.role))


def _apply_column(x: torch.Tensor, t2: torch.Tensor, top: torch.Tensor,
                  slot: torch.Tensor, role: torch.Tensor) -> torch.Tensor:
    """Apply one column of 2x2 cells to ``x[..., n]`` (complex), scatter-free.

    t2: [P, 2, 2] complex cells; top: [P]; slot/role: [n] channel maps.
    """
    a = x.index_select(-1, top)            # [..., P] top channel value
    b = x.index_select(-1, top + 1)        # [..., P] bottom channel value
    a2 = t2[..., 0, 0] * a + t2[..., 0, 1] * b
    b2 = t2[..., 1, 0] * a + t2[..., 1, 1] * b
    from_top = a2.index_select(-1, slot)   # [..., n]
    from_bot = b2.index_select(-1, slot)
    return torch.where(role == _ROLE_TOP, from_top,
                       torch.where(role == _ROLE_BOT, from_bot, x))


def masked_cells(plan: MeshPlan, t_all: torch.Tensor) -> torch.Tensor:
    """Force inactive slots to identity so parked parameters cannot leak in."""
    eye = torch.eye(2, dtype=t_all.dtype, device=t_all.device)
    active = torch.as_tensor(plan.active, device=t_all.device)
    return torch.where(active[..., None, None], t_all, eye)


def scan_columns(plan: MeshPlan, t_all: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Run ``x`` through every column of ``plan`` with cells ``t_all``."""
    top, slot, role = _plan_tensors(plan, x.device)
    t_all = masked_cells(plan, t_all)
    for c in range(plan.n_columns):
        x = _apply_column(x, t_all[c], top[c], slot[c], role[c])
    return x


def apply_screens(x: torch.Tensor, alpha) -> torch.Tensor:
    """Multiply by the phase screen diag(e^{-j alpha}) when one is given."""
    return x if alpha is None else x * expj(alpha)


def apply_mesh(plan: MeshPlan, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Propagate ``x[..., n]`` (complex64) through the mesh.

    Optionally applies an input phase screen ``alpha_in``, then every cell
    column in order, then the output phase screen
    ``Sigma = diag(e^{-j alpha})`` if ``alpha`` is present (paper Eq. 27,
    negative-delay convention).
    """
    if x.shape[-1] != plan.n:
        raise ValueError(f"expected trailing dim {plan.n}, got {tuple(x.shape)}")
    x = apply_screens(as_complex(x), params.get("alpha_in"))
    x = scan_columns(plan, cell_matrix(params["theta"], params["phi"]), x)
    return apply_screens(x, params.get("alpha"))


def mesh_matrix(plan: MeshPlan, params: dict) -> torch.Tensor:
    """Materialize the N x N complex matrix realized by the mesh."""
    eye = torch.eye(plan.n, dtype=torch.complex64,
                    device=params["theta"].device)
    return apply_mesh(plan, params, eye).T  # row k of input -> T e_k


def mesh_is_unitary(plan: MeshPlan, params: dict, atol: float = 1e-4) -> bool:
    u = mesh_matrix(plan, params)
    eye = torch.eye(plan.n, dtype=u.dtype, device=u.device)
    err = (cmatmul(u, u.conj().T) - eye).abs().max()
    return bool(err < atol)
