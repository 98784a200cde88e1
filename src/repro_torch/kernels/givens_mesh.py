"""The mesh kernels on Hopper (forward B1, backward B2) and their plain
PyTorch versions.

``mesh_forward(coef, parity, x)`` computes ``y = T_{C-1} ... T_0 x`` for a
mesh of arbitrary complex 2x2 cells:

  * ``x``, ``y``: complex64 ``[B, n]`` (interleaved re/im, contiguous);
  * ``coef``: float32 ``[C, 8, P]``, rows (t00, t01, t10, t11) x (re, im)
    per pair slot, P = n / 2 — the layout ``schedule.pack_cells`` emits;
  * ``parity``: int32 ``[C]``; 0 pairs (2i, 2i+1), 1 pairs (2i+1, 2i+2).

On a CUDA tensor it launches the hand-written kernel ``csrc/mesh_fwd.cu``
(built for ``sm_90a`` at first use, see :mod:`cuda_build`); on a CPU tensor
it runs :func:`mesh_forward_plain`.  Any other device raises.  There is no
fallback from a kernel to its plain version.

It is differentiable in ``coef`` and ``x``.  The forward keeps only its
output ``y``; the backward rebuilds every column's input from it with the
per-cell inverse and carries the cotangent back with the adjoint
(:func:`inverse_coefficients`, :func:`adjoint_coefficients`).  On a CUDA
tensor that is the kernel ``csrc/mesh_bwd.cu`` (:func:`launch_backward`),
which replaces ``repro/kernels/givens_mesh.py: mesh_bwd_kernel``; on a CPU
tensor its plain version :func:`mesh_backward_plain`.  Gradients follow
PyTorch's complex convention, dL/dRe + i dL/dIm, which is the JAX
package's real-plane cotangent; ``dcoef`` is float32 ``[C, 8, P]``.

The kernel replaces the JAX package's Pallas TPU kernel
``repro/kernels/givens_mesh.py: mesh_kernel`` (via ``mesh_pallas_call``).
It is memory-bound: each row moves 16 n bytes for 28 flops per pair and
column, about n flop/byte for a Clements mesh (8 at the main path's
n = 8), under the H100's float32 ridge of 20 flop/byte.  At n = 8 the
bytes of a call take well under a microsecond, so a launch there is bound
by launch latency.  The TPU kernel's de-interleaved planes were a lane
layout; the CUDA kernel reads and writes interleaved complex64 directly,
which drops the split/merge passes around every call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build, ref
from repro_torch.kernels.ref import (  # noqa: F401  (part of this API)
    adjoint_coefficients,
    inverse_coefficients,
)

#: Launch counters: each is incremented once per launch of its CUDA
#: kernel, nowhere else.  Proof that a run went through the kernels.
LAUNCHES = {"mesh_fwd": 0, "mesh_bwd": 0}

#: The kernels index rows with int32.
_MAX_BATCH = 2**31 - 256


def mesh_forward_plain(coef: torch.Tensor, parity: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same signature)."""
    _check(coef, parity, x)
    return ref.mesh_apply_ref(coef, parity, x)


def _check(coef, parity, x) -> None:
    if x.dim() != 2 or x.dtype != torch.complex64:
        raise ValueError(f"x must be complex64 [B, n], got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, n = x.shape
    if n < 2 or n % 2:
        raise ValueError(f"mesh width must be even and >= 2, got {n}")
    if coef.dim() != 3 or coef.shape[1:] != (8, n // 2) \
            or coef.dtype != torch.float32:
        raise ValueError(f"coef must be float32 [C, 8, {n // 2}], got "
                         f"{coef.dtype} {tuple(coef.shape)}")
    if parity.shape != (coef.shape[0],) or parity.dtype != torch.int32:
        raise ValueError(f"parity must be int32 [{coef.shape[0]}], got "
                         f"{parity.dtype} {tuple(parity.shape)}")
    if not (coef.device == parity.device == x.device):
        raise ValueError(f"coef, parity and x must share a device, got "
                         f"{coef.device}, {parity.device}, {x.device}")


def mesh_backward_plain(coef: torch.Tensor, parity: torch.Tensor,
                        y: torch.Tensor, g: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of kernel B2: ``(dcoef, dx)`` from the
    forward's output ``y`` and the cotangent ``g`` at it."""
    _check_backward(coef, parity, y, g)
    dcoef, gx = ref.mesh_apply_planes_bwd(coef, parity, ref.split_channels(y),
                                          ref.split_channels(g))
    return dcoef, ref.merge_channels(*gx)


def _check_backward(coef, parity, y, g) -> None:
    _check(coef, parity, y)
    if g.shape != y.shape or g.dtype != y.dtype or g.device != y.device:
        raise ValueError(f"cotangent must match y {y.dtype} "
                         f"{tuple(y.shape)} on {y.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")


def _on_card(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA tensors, got "
                         f"{x.device}")
    b = x.shape[0]
    if b >= _MAX_BATCH:
        raise ValueError(f"batch {b} exceeds the {name} kernel's int32 row "
                         "index")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a lazy conjugate or negation materialized: the
    kernels read raw memory."""
    return t.resolve_conj().resolve_neg().contiguous()


def _lib(name: str, argtypes: dict) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    for fn_name, args in argtypes.items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = {"mesh_fwd_launch": [_P, _P, _P, _P, _I, _I, _I, _P]}
_BWD_ARGS = {"mesh_bwd_blocks": [_I, _I],
             "mesh_bwd_launch": [_P] * 7 + [_I] * 4 + [_P]}


def launch(coef: torch.Tensor, parity: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no autograd)."""
    _check(coef, parity, x)
    _on_card("mesh", x)
    b, n = x.shape
    coef, parity, x = coef.contiguous(), parity.contiguous(), _dense(x)
    y = torch.empty_like(x)
    if b == 0:  # a grid of 0 blocks is an invalid launch
        return y
    fn = _lib("mesh_fwd", _FWD_ARGS).mesh_fwd_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), coef.data_ptr(),
                 parity.data_ptr(), b, n, coef.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"mesh_fwd launch failed: CUDA error {err} "
                           f"(B={b}, n={n}, C={coef.shape[0]})")
    LAUNCHES["mesh_fwd"] += 1
    return y


def launch_backward(coef: torch.Tensor, parity: torch.Tensor, y: torch.Tensor,
                    g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B2 on the current stream: ``(dcoef, dx)`` from the
    forward's output ``y`` and the cotangent ``g`` (no autograd).

    Each block writes its batch-summed coefficient gradient into its own
    slice of a ``[blocks, C, 8, P]`` scratch, and a second kernel sums the
    slices in block order: ``dcoef`` is the same bits on every call.
    """
    _check_backward(coef, parity, y, g)
    _on_card("mesh backward", y)
    b, n = y.shape
    c = coef.shape[0]
    coef, parity = coef.contiguous(), parity.contiguous()
    y, g = _dense(y), _dense(g)
    if b == 0:  # nothing to sum and a 0-block grid is an invalid launch
        return torch.zeros_like(coef), torch.empty_like(y)
    lib = _lib("mesh_bwd", _BWD_ARGS)
    with torch.cuda.device(y.device):
        blocks = lib.mesh_bwd_blocks(b, n)
        if blocks <= 0:
            raise RuntimeError(f"mesh_bwd_blocks failed: CUDA error {-blocks}")
        partial = torch.empty((blocks, c, 8, n // 2), dtype=torch.float32,
                              device=y.device)
        dcoef = torch.empty_like(coef)
        dx = torch.empty_like(y)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.mesh_bwd_launch(y.data_ptr(), g.data_ptr(), coef.data_ptr(),
                                  parity.data_ptr(), partial.data_ptr(),
                                  dcoef.data_ptr(), dx.data_ptr(), b, n, c,
                                  blocks, stream)
    if err != 0:
        raise RuntimeError(f"mesh_bwd launch failed: CUDA error {err} "
                           f"(B={b}, n={n}, C={c}, blocks={blocks})")
    LAUNCHES["mesh_bwd"] += 1
    return dcoef, dx


class _MeshSweep(torch.autograd.Function):
    """The sweep under autograd: B1 forward and B2 backward on a CUDA
    tensor, their plain versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, coef, parity, x):
        if x.device.type == "cuda":
            y = launch(coef, parity, x)
        else:
            y = mesh_forward_plain(coef, parity, x)
        ctx.save_for_backward(coef, parity, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        coef, parity, y = ctx.saved_tensors
        if y.device.type == "cuda":
            dcoef, dx = launch_backward(coef, parity, y, g)
        elif y.device.type == "cpu":
            dcoef, dx = mesh_backward_plain(coef, parity, y, g)
        else:
            raise ValueError(f"no mesh backward for {y.device} tensors")
        return dcoef, None, dx


def mesh_forward(coef: torch.Tensor, parity: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``y = T_{C-1} ... T_0 x``: the CUDA kernels on a CUDA tensor, the
    plain versions on a CPU tensor; any other device raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mesh_forward runs on cuda or cpu tensors, got "
                         f"{x.device}")
    return _MeshSweep.apply(coef, parity, x)
