"""The mesh forward kernel on Hopper and its plain PyTorch version.

``mesh_forward(coef, parity, x)`` computes ``y = T_{C-1} ... T_0 x`` for a
mesh of arbitrary complex 2x2 cells:

  * ``x``, ``y``: complex64 ``[B, n]`` (interleaved re/im, contiguous);
  * ``coef``: float32 ``[C, 8, P]``, rows (t00, t01, t10, t11) x (re, im)
    per pair slot, P = n / 2 — the layout ``schedule.pack_cells`` emits;
  * ``parity``: int32 ``[C]``; 0 pairs (2i, 2i+1), 1 pairs (2i+1, 2i+2).

On a CUDA tensor it launches the hand-written kernel ``csrc/mesh_fwd.cu``
(built for ``sm_90a`` at first use, see :mod:`cuda_build`); on a CPU tensor
it runs :func:`mesh_forward_plain`.  Any other device raises.  There is no
fallback from the kernel to the plain version.

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

#: Launch counter: incremented once per launch of the CUDA kernel, nowhere
#: else.  Proof that a run went through the kernel.
LAUNCHES = {"mesh_fwd": 0}

_BACKWARD_MSG = "mesh backward kernel (B2) lands with the training slice"


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


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mesh_fwd")
    fn = lib.mesh_fwd_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def launch(coef: torch.Tensor, parity: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no autograd)."""
    _check(coef, parity, x)
    if x.device.type != "cuda":
        raise ValueError(f"the mesh kernel runs on CUDA tensors, got {x.device}")
    b, n = x.shape
    if b >= 2**31 - 256:
        raise ValueError(f"batch {b} exceeds the kernel's int32 row index")
    coef, parity, x = coef.contiguous(), parity.contiguous(), x.contiguous()
    y = torch.empty_like(x)
    if b == 0:  # a grid of 0 blocks is an invalid launch
        return y
    fn = _lib().mesh_fwd_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), coef.data_ptr(),
                 parity.data_ptr(), b, n, coef.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"mesh_fwd launch failed: CUDA error {err} "
                           f"(B={b}, n={n}, C={coef.shape[0]})")
    LAUNCHES["mesh_fwd"] += 1
    return y


class _MeshForwardKernel(torch.autograd.Function):
    """The kernel under autograd.  Its backward (kernel B2) is not ported
    yet, so asking for a gradient on a CUDA tensor raises."""

    @staticmethod
    def forward(ctx, coef, parity, x):
        return launch(coef, parity, x)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(_BACKWARD_MSG)


def mesh_forward(coef: torch.Tensor, parity: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``y = T_{C-1} ... T_0 x``: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor; any other device raises."""
    if x.device.type == "cuda":
        return _MeshForwardKernel.apply(coef, parity, x)
    if x.device.type == "cpu":
        return mesh_forward_plain(coef, parity, x)
    raise ValueError(f"mesh_forward runs on cuda or cpu tensors, got {x.device}")
