"""Trainable analog layers backed by the RF processor (paper Sec. IV).

:class:`AnalogUnitary` — an N x N mesh whose phases are trained directly
(the paper's MNIST hidden layer: an 8x8 mesh of 28 cells, Fig. 14), with
Table-I discrete-phase quantization (straight-through gradients) and the
hardware-imperfection model.

``backend="kernel"`` (the default) runs the mesh through
:func:`repro_torch.kernels.ops.mesh_apply`: the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor.  ``backend="reference"`` runs
the column scan of :mod:`repro_torch.core.mesh`.  Both consume the same
generator draws, so they are draw-for-draw comparable under noise.  (The
JAX package defaults to its reference backend; the port defaults to the
kernel.)
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import hardware as hw_lib
from repro_torch.core import mesh as mesh_lib
from repro_torch.core import quantize as q_lib
from repro_torch.core.cell import as_complex
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops

OutputMode = Literal["abs", "real", "complex"]
Backend = Literal["kernel", "reference"]
BACKENDS = ("kernel", "reference")


def _readout(y: torch.Tensor, output: OutputMode,
             hw: hw_lib.HardwareModel | None,
             generator: torch.Generator | None) -> torch.Tensor:
    if output == "complex":
        return y
    if output == "abs":
        if hw is not None:
            return hw_lib.detect_magnitude(y, hw, generator)
        return y.abs()
    return y.real


@dataclasses.dataclass(frozen=True)
class AnalogUnitary:
    """N x N unitary mesh layer with directly trained phases."""

    n: int
    quantize: str | None = None      # None | "table1" | "uniform<bits>"
    hardware: hw_lib.HardwareModel | None = None
    output: OutputMode = "complex"
    backend: Backend = "kernel"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        object.__setattr__(self, "_plan", mesh_lib.clements_plan(self.n))

    @property
    def plan(self) -> mesh_lib.MeshPlan:
        return self._plan  # type: ignore[attr-defined]

    def codebook(self, device=None) -> torch.Tensor | None:
        if self.quantize is None:
            return None
        if self.quantize == "table1":
            return q_lib.table_i_codebook(device)
        if self.quantize.startswith("uniform"):
            return q_lib.uniform_codebook(int(self.quantize[len("uniform"):]),
                                          device=device)
        raise ValueError(f"unknown quantize mode {self.quantize!r}")

    def init(self, generator: torch.Generator, *, device=None) -> dict:
        """Random phases from a CPU ``generator``, on ``device`` (CUDA when
        None; raises when CUDA is absent)."""
        return mesh_lib.init_mesh_params(generator, self.plan, with_sigma=True,
                                         device=resolve_device(device))

    def effective_params(self, params: dict) -> dict:
        cb = self.codebook(params["theta"].device)
        if cb is None:
            return params
        return q_lib.quantize_mesh_params(params, cb, ste=True)

    def apply(self, params: dict, x, *,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Run ``x[..., n]`` through the mesh on the params' device.

        With a ``generator`` and a hardware model, phase noise and then
        detector noise are drawn from it.
        """
        p = self.effective_params(params)
        xc = as_complex(torch.as_tensor(x, device=params["theta"].device))
        gen = generator if self.hardware is not None else None
        if self.backend == "kernel":
            y = kernel_ops.mesh_apply(p, xc, n=self.n, plan=self.plan,
                                      hardware=self.hardware, generator=gen)
        elif self.hardware is not None:
            y = hw_lib.apply_mesh_hw(self.plan, p, xc, self.hardware, gen)
        else:
            y = mesh_lib.apply_mesh(self.plan, p, xc)
        return _readout(y, self.output, self.hardware, gen)

    def matrix(self, params: dict) -> torch.Tensor:
        return mesh_lib.mesh_matrix(self.plan, self.effective_params(params))

    def n_cells(self) -> int:
        return self.plan.n_cells
