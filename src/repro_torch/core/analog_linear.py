"""Trainable analog layers backed by the RF processor (paper Sec. IV).

* :class:`AnalogUnitary` — an N x N mesh whose phases are trained directly
  (the paper's MNIST hidden layer: an 8x8 mesh of 28 cells, Fig. 14).
* :class:`AnalogLinear` — an arbitrary (out x in) matrix in SVD form,
  V-mesh -> attenuation -> U-mesh with a digital scale gamma (Eq. 31 and
  Fig. 11's pre/post scaling); trained, or programmed from a target matrix
  (:meth:`AnalogLinear.init_from_matrix`).

Both support Table-I discrete-phase quantization (straight-through
gradients) and the hardware-imperfection model.

``backend="kernel"`` (the default) runs the meshes through the kernel path:
:func:`repro_torch.kernels.ops.mesh_apply` (kernels B1/B2) and, for
``AnalogLinear(output="abs")``, the fused layer
:func:`repro_torch.kernels.ops.rfnn_linear` (kernels B3/B4/B5): the CUDA
kernels on CUDA tensors, their plain versions on CPU tensors.
``backend="reference"`` runs the column scan of :mod:`repro_torch.core.mesh`.
Both consume the same generator draws, so they are draw-for-draw
comparable under noise.  (The JAX package defaults to its reference
backend; the port defaults to the kernel.)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
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


def _codebook(mode: str | None, device) -> torch.Tensor | None:
    if mode is None:
        return None
    if mode == "table1":
        return q_lib.table_i_codebook(device)
    if mode.startswith("uniform"):
        return q_lib.uniform_codebook(int(mode[len("uniform"):]), device=device)
    raise ValueError(f"unknown quantize mode {mode!r}")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


@dataclasses.dataclass(frozen=True)
class AnalogUnitary:
    """N x N unitary mesh layer with directly trained phases."""

    n: int
    quantize: str | None = None      # None | "table1" | "uniform<bits>"
    hardware: hw_lib.HardwareModel | None = None
    output: OutputMode = "complex"
    backend: Backend = "kernel"

    def __post_init__(self):
        _check_backend(self.backend)
        object.__setattr__(self, "_plan", mesh_lib.clements_plan(self.n))

    @property
    def plan(self) -> mesh_lib.MeshPlan:
        return self._plan  # type: ignore[attr-defined]

    def codebook(self, device=None) -> torch.Tensor | None:
        return _codebook(self.quantize, device)

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


@dataclasses.dataclass(frozen=True)
class AnalogLinear:
    """Arbitrary (out x in) analog matrix in SVD mesh form:
    ``y = gamma . U (D (V x))`` on an n x n pair of meshes, n the even
    enclosing size of (out, in)."""

    in_dim: int
    out_dim: int
    quantize: str | None = None
    hardware: hw_lib.HardwareModel | None = None
    output: OutputMode = "real"
    backend: Backend = "kernel"

    def __post_init__(self):
        _check_backend(self.backend)
        n = max(self.in_dim, self.out_dim)
        n += n % 2
        object.__setattr__(self, "n", n)
        plan = mesh_lib.clements_plan(n)
        object.__setattr__(self, "_u_plan", plan)
        object.__setattr__(self, "_v_plan", plan)

    @property
    def u_plan(self) -> mesh_lib.MeshPlan:
        return self._u_plan  # type: ignore[attr-defined]

    @property
    def v_plan(self) -> mesh_lib.MeshPlan:
        return self._v_plan  # type: ignore[attr-defined]

    def init(self, generator: torch.Generator, *, device=None) -> dict:
        """Random params from a CPU ``generator`` (U's phases, V's, then the
        attenuation logits), on ``device`` (CUDA when None; raises when CUDA
        is absent)."""
        device = resolve_device(device)
        n = self.n
        u = mesh_lib.init_mesh_params(generator, self.u_plan, with_sigma=True,
                                      device=device)
        v = mesh_lib.init_mesh_params(generator, self.v_plan, with_sigma=True,
                                      device=device)
        logits = torch.randn(n, generator=generator, dtype=torch.float32)
        # digital scale gamma, softplus-positive, near the Glorot scale
        gamma = math.sqrt(2.0 / (self.in_dim + self.out_dim)) \
            * math.sqrt(self.in_dim)
        return {"u": u, "v": v,
                # attenuation in [0, 1] via the sigmoid of a free logit
                "atten_logit": (logits * 0.5 + 1.0).to(device),
                "log_scale": torch.tensor(np.log(np.expm1(gamma)),
                                          dtype=torch.float32, device=device)}

    def _quant(self, mp: dict) -> dict:
        cb = _codebook(self.quantize, mp["theta"].device)
        if cb is None:
            return mp
        return q_lib.quantize_mesh_params(mp, cb, ste=True)

    def apply(self, params: dict, x, *,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Run ``x[..., in_dim]`` through the layer on the params' device;
        returns ``[..., out_dim]``.

        With a ``generator`` and a hardware model, V's phase noise, then
        U's, then the detector's noise are drawn from it.
        """
        device = params["atten_logit"].device
        xc = as_complex(torch.as_tensor(x, device=device))
        pad = self.n - xc.shape[-1]
        if pad:
            xc = torch.cat([xc, xc.new_zeros(xc.shape[:-1] + (pad,))], -1)
        u_p, v_p = self._quant(params["u"]), self._quant(params["v"])
        atten = torch.sigmoid(params["atten_logit"])
        scale = torch.nn.functional.softplus(params["log_scale"])
        hw = self.hardware
        gen = generator if hw is not None else None
        if self.backend == "kernel" and self.output == "abs":
            # one fused kernel: V-mesh -> diag -> U-mesh -> |detect|; the
            # detector's noise and floor compose on the magnitudes
            y = kernel_ops.rfnn_linear(
                v_p, atten, u_p, xc, n=self.n, scale=scale,
                v_plan=self.v_plan, u_plan=self.u_plan, hardware=hw,
                generator=gen)
            return _readout(y[..., : self.out_dim], "abs", hw, gen)
        if self.backend == "kernel":
            h = kernel_ops.mesh_apply(v_p, xc, n=self.n, plan=self.v_plan,
                                      hardware=hw, generator=gen)
            h = h * atten.to(torch.complex64)
            y = kernel_ops.mesh_apply(u_p, h, n=self.n, plan=self.u_plan,
                                      hardware=hw, generator=gen)
        elif hw is not None:
            h = hw_lib.apply_mesh_hw(self.v_plan, v_p, xc, hw, gen)
            h = h * atten.to(torch.complex64)
            y = hw_lib.apply_mesh_hw(self.u_plan, u_p, h, hw, gen)
        else:
            h = mesh_lib.apply_mesh(self.v_plan, v_p, xc)
            h = h * atten.to(torch.complex64)
            y = mesh_lib.apply_mesh(self.u_plan, u_p, h)
        return _readout(scale * y[..., : self.out_dim], self.output, hw, gen)

    def init_from_matrix(self, m: np.ndarray, *, device=None) -> dict:
        """Program the layer to realize the matrix ``m`` (on ``device``,
        CUDA when None).

        Runs the compiler's ``synthesize`` + ``program`` passes (analytic
        Reck factorization) and adopts the program's plans: reprogramming
        the device changes its physical layout, not the API.
        """
        from repro_torch import compile as compile_mod  # core <-> compile

        prog = compile_mod.program(compile_mod.synthesize(m, device=device),
                                   method="reck")
        la = prog.layers[0]
        if la.n != self.n:
            raise ValueError(f"matrix pad size {la.n} != layer size {self.n}")
        params = {"u": dict(la.u_params), "v": dict(la.v_params),
                  "atten_logit": compile_mod.logit(la.attenuation),
                  "log_scale": compile_mod.inv_softplus(la.scale)}
        object.__setattr__(self, "_u_plan", la.u_plan)
        object.__setattr__(self, "_v_plan", la.v_plan)
        return params

    def n_cells(self) -> int:
        return self.u_plan.n_cells + self.v_plan.n_cells
