"""The ``AnalogProgram`` IR (the subset the ``synthesize``/``program``
passes use): the counterpart of the JAX package's
``repro.compile.program``.

* :class:`ProgramLayer` — one analog layer ``y = gamma . U (D (V x))``: the
  SVD targets, the diagonal attenuation and digital gamma, and the mesh
  plans/params filled in by the ``program`` pass.
* :class:`AnalogProgram` — an L-layer stack of those (one entry for a
  single matrix).

The IR is host-side (frozen dataclasses); the attenuation, scale and mesh
params are tensors on the device the program was synthesized for.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import mesh as mesh_lib
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class ProgramLayer:
    """One analog layer of the IR; the ``program`` pass fills in the meshes."""

    n: int                      # padded square mesh size (even)
    out_dim: int
    in_dim: int
    target: np.ndarray          # [out_dim, in_dim] digital weight matrix
    target_u: np.ndarray        # [n, n] unitary (SVD left factor)
    target_vh: np.ndarray       # [n, n] unitary (SVD right factor, V^H)
    attenuation: torch.Tensor   # [n] diagonal D / sigma_max, in [0, 1]
    scale: torch.Tensor         # digital gamma (sigma_max), 0-d float32
    # filled by the ``program`` pass
    v_plan: mesh_lib.MeshPlan | None = None
    v_params: dict | None = None
    u_plan: mesh_lib.MeshPlan | None = None
    u_params: dict | None = None

    @property
    def programmed(self) -> bool:
        return self.v_params is not None and self.u_params is not None

    @property
    def device(self) -> torch.device:
        return self.attenuation.device

    def replace(self, **kw) -> "ProgramLayer":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class AnalogProgram:
    """An L-layer analog program (L == 1 for a single matrix)."""

    layers: tuple[ProgramLayer, ...]

    def __post_init__(self):
        if not self.layers:
            raise ValueError("an AnalogProgram needs at least one layer")
        n = self.layers[0].n
        if any(la.n != n for la in self.layers):
            raise ValueError(
                f"all layers must share the padded mesh size, got "
                f"{[la.n for la in self.layers]}")

    @property
    def n(self) -> int:
        return self.layers[0].n

    @property
    def depth(self) -> int:
        return len(self.layers)

    @property
    def in_dim(self) -> int:
        return self.layers[0].in_dim

    @property
    def out_dim(self) -> int:
        return self.layers[-1].out_dim

    @property
    def programmed(self) -> bool:
        return all(la.programmed for la in self.layers)

    def n_cells(self) -> int:
        return sum(la.v_plan.n_cells + la.u_plan.n_cells
                   for la in self.layers if la.programmed)


def layer_matrix(layer: ProgramLayer) -> np.ndarray:
    """The complex [out_dim, in_dim] matrix a programmed layer realizes.

    Runs the kernel path: two ``ops.mesh_apply`` probes over the identity
    batch, on the layer's device.
    """
    if not layer.programmed:
        raise ValueError("layer is not programmed")
    probes = torch.eye(layer.n, dtype=torch.complex64, device=layer.device)
    with torch.no_grad():
        h = kernel_ops.mesh_apply(layer.v_params, probes, n=layer.n,
                                  plan=layer.v_plan)
        h = h * layer.attenuation.to(torch.complex64)
        h = kernel_ops.mesh_apply(layer.u_params, h, n=layer.n,
                                  plan=layer.u_plan)
        rec = layer.scale.to(torch.complex64) * h
    return rec.cpu().numpy().T[: layer.out_dim, : layer.in_dim]


def program_error(prog: AnalogProgram) -> float:
    """Worst-case elementwise synthesis error across the program's layers."""
    return max(float(np.abs(layer_matrix(la) - la.target).max())
               for la in prog.layers)
