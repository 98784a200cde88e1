"""Arbitrary-matrix synthesis via SVD (paper Eq. 31, Sec. IV-B): the
counterpart of the JAX package's ``repro.core.svd_synthesis``.

A facade over the compiler's ``synthesize`` + ``program`` passes (analytic
Reck factorization): :meth:`SynthesizedMatrix.apply` runs V-mesh ->
attenuation -> U-mesh through ``ops.mesh_apply`` (kernel B1 on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import mesh as mesh_lib
from repro_torch.core.cell import as_complex
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass
class SynthesizedMatrix:
    """A programmed analog realization of an arbitrary matrix."""

    out_dim: int
    in_dim: int
    n: int  # padded square size (even)
    u_plan: mesh_lib.MeshPlan
    u_params: dict
    v_plan: mesh_lib.MeshPlan
    v_params: dict
    attenuation: torch.Tensor  # [n] in [0, 1]: diagonal D / sigma_max
    scale: float  # sigma_max, recovered in digital post-processing

    @property
    def n_cells(self) -> int:
        return self.u_plan.n_cells + self.v_plan.n_cells

    def apply(self, x) -> torch.Tensor:
        """y = M x for x[..., in_dim] on the params' device; returns
        [..., out_dim] (complex64)."""
        x = as_complex(torch.as_tensor(x, device=self.attenuation.device))
        if x.shape[-1] != self.in_dim:
            raise ValueError(
                f"expected trailing dim {self.in_dim}, got {tuple(x.shape)}")
        pad = self.n - x.shape[-1]
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], -1)
        h = kernel_ops.mesh_apply(self.v_params, x, n=self.n, plan=self.v_plan)
        h = h * self.attenuation.to(torch.complex64)
        h = kernel_ops.mesh_apply(self.u_params, h, n=self.n, plan=self.u_plan)
        return self.scale * h[..., : self.out_dim]

    def matrix(self) -> np.ndarray:
        eye = torch.eye(self.in_dim, dtype=torch.complex64,
                        device=self.attenuation.device)
        with torch.no_grad():
            return self.apply(eye).cpu().numpy().T


def synthesize(m: np.ndarray, *, device=None) -> SynthesizedMatrix:
    """Program an analog realization of the (possibly rectangular) matrix
    ``m`` on ``device`` (CUDA when None), by the compiler's ``synthesize`` +
    ``program(method="reck")`` passes."""
    from repro_torch import compile as compile_mod  # core <-> compile

    prog = compile_mod.program(compile_mod.synthesize(m, device=device),
                               method="reck")
    la = prog.layers[0]
    return SynthesizedMatrix(
        out_dim=la.out_dim, in_dim=la.in_dim, n=la.n,
        u_plan=la.u_plan, u_params=la.u_params,
        v_plan=la.v_plan, v_params=la.v_params,
        attenuation=la.attenuation, scale=float(la.scale))


def synthesis_error(m: np.ndarray, syn: SynthesizedMatrix) -> float:
    return float(np.abs(syn.matrix() - np.asarray(m)).max())
