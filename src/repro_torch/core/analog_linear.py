"""Trainable analog layers backed by the RF processor (paper Sec. IV).

* :class:`AnalogUnitary` — an N x N mesh whose phases are trained directly
  (the paper's MNIST hidden layer: an 8x8 mesh of 28 cells, Fig. 14).
* :class:`AnalogLinear` — an arbitrary (out x in) matrix in SVD form,
  V-mesh -> attenuation -> U-mesh with a digital scale gamma (Eq. 31 and
  Fig. 11's pre/post scaling); trained, or programmed from a target matrix
  (:meth:`AnalogLinear.init_from_matrix`).
* :class:`AnalogSequence` — an L-deep stack of square analog linear layers
  with |.| detection between them (the paper's Sec.-V multi-layer
  microwave ANN).
* :class:`TiledAnalogLinear` — a large (out x in) matmul as a grid of
  tile-sized AnalogLinear cores whose row outputs combine coherently.

All support Table-I discrete-phase quantization (straight-through
gradients) and the hardware-imperfection model.

``backend="kernel"`` (the default) runs the meshes through the kernel path:
:func:`repro_torch.kernels.ops.mesh_apply` (kernels B1/B2) and, for
``AnalogLinear(output="abs")``, the fused layer
:func:`repro_torch.kernels.ops.rfnn_linear` (kernels B3/B4/B5): the CUDA
kernels on CUDA tensors, their plain versions on CPU tensors.
``AnalogSequence`` and ``TiledAnalogLinear`` run the whole network or grid
through the deep-grid kernels B6/B7/B8 (:func:`repro_torch.kernels.ops.
rfnn_network`, :func:`~repro_torch.kernels.ops.tiled_apply`), one launch
per direction.
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


def _stack_trees(trees: list, lead: tuple[int, ...]):
    """Stack equal-structured param dicts into ``lead + shape`` leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees], lead) for k in trees[0]}
    return torch.stack(trees).reshape(lead + trees[0].shape)


@dataclasses.dataclass(frozen=True)
class AnalogSequence:
    """An L-deep stack of square n x n analog linear layers (the paper's
    multi-layer microwave ANN, Sec. V): per layer V-mesh -> attenuation ->
    U-mesh -> digital scale -> |detect|, the detected magnitude feeding the
    next layer.

    With ``backend="kernel"`` the whole network runs through the deep-grid
    kernels (``ops.rfnn_network``), one launch per direction; its packed
    coefficients are cached per parameter identity, so steady-state
    inference packs nothing.  The reference backend composes the per-layer
    :class:`AnalogLinear` modules.  Inter-layer detection is the ideal
    ``|.|``; the detector chain's noise and floor apply once, at the
    readout (``output="abs"`` with a hardware model).
    """

    n: int
    depth: int
    quantize: str | None = None
    hardware: hw_lib.HardwareModel | None = None
    output: OutputMode = "abs"
    backend: Backend = "kernel"

    def __post_init__(self):
        _check_backend(self.backend)
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        object.__setattr__(self, "_layer", AnalogLinear(
            in_dim=self.n, out_dim=self.n, quantize=self.quantize,
            hardware=self.hardware, output="complex", backend=self.backend))

    @property
    def layer(self) -> AnalogLinear:
        return self._layer  # type: ignore[attr-defined]

    def init(self, generator: torch.Generator, *, device=None) -> dict:
        """Random params of every layer, drawn in layer order from a CPU
        ``generator`` (each as :meth:`AnalogLinear.init`), on ``device``
        (CUDA when None; raises when CUDA is absent)."""
        return {"layers": tuple(self.layer.init(generator, device=device)
                                for _ in range(self.depth))}

    def apply(self, params: dict, x, *,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Run ``x[..., n]`` through the stack on the params' device.

        With a ``generator`` and a hardware model, the draws are, layer by
        layer, V's phase noise then U's, then the readout's detector noise,
        on both backends.
        """
        layers = params["layers"]
        device = layers[0]["atten_logit"].device
        xc = as_complex(torch.as_tensor(x, device=device))
        hw = self.hardware
        gen = generator if hw is not None else None
        if self.backend == "kernel":
            args = kernel_ops.memoize_by_leaf_ids(
                ("analog_sequence_args", self), (layers, gen),
                lambda: self._layer_args(layers, gen))
            y = kernel_ops.rfnn_network(args, xc, n=self.n, hardware=hw)
            return _readout(y, self.output, hw, gen)
        h = xc
        for p in layers:
            h = self.layer.apply(p, h, generator=gen).abs()
        return _readout(h, self.output, hw, gen)

    def _layer_args(self, layers, generator) -> tuple:
        args = []
        for p in layers:
            la = {"v": self.layer._quant(p["v"]),
                  "u": self.layer._quant(p["u"]),
                  "atten": torch.sigmoid(p["atten_logit"]),
                  "scale": torch.nn.functional.softplus(p["log_scale"])}
            if generator is not None:
                la["generator"] = generator
            args.append(la)
        return tuple(args)

    def n_cells(self) -> int:
        return self.depth * self.layer.n_cells()


@dataclasses.dataclass(frozen=True)
class TiledAnalogLinear:
    """A large (out x in) matmul as a (To x Ti) grid of tile_size^2 analog
    SVD cores; each row's tile outputs combine coherently (a power combiner
    after matched lines) and the readout applies after the combination.

    With ``backend="kernel"`` the whole grid runs through the deep-grid
    kernels (``ops.tiled_apply``), one launch per direction; packed
    coefficients are cached per parameter identity.  The reference backend
    composes the To x Ti per-tile :class:`AnalogLinear` applies.  Params
    are the tiles' params stacked to ``[To, Ti, ...]`` leaves.
    """

    in_dim: int
    out_dim: int
    tile_size: int = 16
    quantize: str | None = None
    hardware: hw_lib.HardwareModel | None = None
    output: OutputMode = "real"
    backend: Backend = "kernel"

    def __post_init__(self):
        _check_backend(self.backend)
        t = self.tile_size
        if t % 2:
            raise ValueError("tile_size must be even")
        if self.in_dim % t or self.out_dim % t:
            raise ValueError(f"dims ({self.out_dim},{self.in_dim}) must be "
                             f"multiples of tile {t}")
        object.__setattr__(self, "_tile", AnalogLinear(
            in_dim=t, out_dim=t, quantize=self.quantize, hardware=None,
            output="complex", backend=self.backend))

    @property
    def tile(self) -> AnalogLinear:
        return self._tile  # type: ignore[attr-defined]

    def grid(self) -> tuple[int, int]:
        return (self.out_dim // self.tile_size, self.in_dim // self.tile_size)

    def init(self, generator: torch.Generator, *, device=None) -> dict:
        """Random params drawn tile by tile from a CPU ``generator``, row by
        row (tile (0, 0), (0, 1), ..., then (1, 0), ...), each as
        :meth:`AnalogLinear.init`, stacked to ``[To, Ti, ...]`` on
        ``device`` (CUDA when None; raises when CUDA is absent)."""
        to, ti = self.grid()
        return _stack_trees([self.tile.init(generator, device=device)
                             for _ in range(to * ti)], (to, ti))

    def apply(self, params: dict, x, *,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Run ``x[..., in_dim]`` through the grid on the params' device;
        returns ``[..., out_dim]``.  The tiles are noiseless; with a hardware
        model and ``output="abs"`` the detector's noise is drawn from
        ``generator``."""
        to, ti = self.grid()
        t = self.tile_size
        xc = as_complex(torch.as_tensor(x, device=params["atten_logit"].device))
        if self.backend == "kernel":
            tiles = kernel_ops.memoize_by_leaf_ids(("tiled_analog_args", self), params,
                                        lambda: self._tile_args(params))
            # every tile shares the module's plan pair
            pair = (self.tile.v_plan, self.tile.u_plan)
            y = kernel_ops.tiled_apply(tiles, xc, n=t,
                                       plans=((pair,) * ti,) * to)
        else:
            xt = xc.reshape(xc.shape[:-1] + (ti, t))
            rows = []
            for o in range(to):
                row = 0
                for i in range(ti):
                    p = _tile_params(params, o, i)
                    row = row + self.tile.apply(p, xt[..., i, :])
                rows.append(row)  # the coherent combine over the row's tiles
            y = torch.stack(rows, -2).reshape(xc.shape[:-1] + (self.out_dim,))
        if self.hardware is not None and self.output == "abs":
            return hw_lib.detect_magnitude(y, self.hardware, generator)
        return _readout(y, self.output, None, None)

    def _tile_args(self, params: dict) -> tuple:
        """Per-tile kernel argument dicts from the stacked params: quantized
        phases, sigmoid attenuation and softplus scale, derived once for the
        whole grid (each is elementwise) and sliced per tile."""
        to, ti = self.grid()
        v, u = self.tile._quant(params["v"]), self.tile._quant(params["u"])
        atten = torch.sigmoid(params["atten_logit"])
        scale = torch.nn.functional.softplus(params["log_scale"])
        return tuple(tuple({"v": {k: a[o, i] for k, a in v.items()},
                            "u": {k: a[o, i] for k, a in u.items()},
                            "atten": atten[o, i], "scale": scale[o, i]}
                           for i in range(ti)) for o in range(to))

    def n_cells(self) -> int:
        to, ti = self.grid()
        return to * ti * self.tile.n_cells()


def _tile_params(params: dict, o: int, i: int) -> dict:
    return {k: (_tile_params(v, o, i) if isinstance(v, dict) else v[o, i])
            for k, v in params.items()}
