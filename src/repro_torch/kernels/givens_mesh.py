"""The mesh kernels on Hopper (forward B1, backward B2), the fused analog
linear layer's kernels (B3, B4, backward B5) and their plain PyTorch
versions.

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

``rfnn_forward(coef_v, par_v, coef_u, par_u, gains, x)`` is the fused
analog linear layer ``|g2 * U (g1 * V x)|`` (paper Eq. 31): two meshes
(``Cv`` and ``Cu`` columns, which may differ), a complex mid gain ``g1``
and post gain ``g2`` in the JAX package's float32 ``[8, P]`` layout (rows
0-3 g1, 4-7 g2; even re, even im, odd re, odd im) and the detector's
magnitude, float32 ``[B, n]`` in channel order.  On a CUDA tensor it runs
``csrc/rfnn_fwd.cu``: kernel B3 (``rfnn_linear_kernel``) when no input
needs a gradient, else kernel B4 (``rfnn_linear_fwd_kernel``), which also
saves the post-V and post-U stage boundaries, and on the way back kernel
B5 (``csrc/rfnn_bwd.cu``, ``rfnn_linear_bwd_kernel``).  On a CPU tensor it
runs the plain versions in :mod:`ref`.  ``dg`` is the real-plane gradient
of the gains; autograd carries it back into the attenuation, the scale and
the folded phase screens.
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
LAUNCHES = {"mesh_fwd": 0, "mesh_bwd": 0, "rfnn_fwd": 0, "rfnn_fwd_res": 0,
            "rfnn_bwd": 0}

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


# ---------------------------------------------------------------------------
# the fused analog linear layer: B3 / B4 forward, B5 backward
# ---------------------------------------------------------------------------

def _check_rfnn(coef_v, par_v, coef_u, par_u, gains, x) -> None:
    _check(coef_v, par_v, x)
    _check(coef_u, par_u, x)
    p = x.shape[1] // 2
    if gains.shape != (8, p) or gains.dtype != torch.float32:
        raise ValueError(f"gains must be float32 [8, {p}], got {gains.dtype} "
                         f"{tuple(gains.shape)}")
    if gains.device != x.device:
        raise ValueError(f"gains on {gains.device}, x on {x.device}")


def _check_rfnn_backward(coef_v, par_v, coef_u, par_u, gains, v, u, g) -> None:
    _check_rfnn(coef_v, par_v, coef_u, par_u, gains, v)
    if u.shape != v.shape or u.dtype != v.dtype or u.device != v.device:
        raise ValueError(f"post-U boundary must match post-V {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}, got {u.dtype} "
                         f"{tuple(u.shape)} on {u.device}")
    if g.shape != v.shape or g.dtype != torch.float32 or g.device != v.device:
        raise ValueError(f"cotangent must be float32 {tuple(v.shape)} on "
                         f"{v.device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")


def rfnn_forward_plain(coef_v, par_v, coef_u, par_u, gains, x):
    """The plain PyTorch version of kernels B3/B4: ``(out, v, u)``, the
    magnitudes and the post-V and post-U stage boundaries."""
    _check_rfnn(coef_v, par_v, coef_u, par_u, gains, x)
    return ref.rfnn_linear_planes(coef_v, par_v, coef_u, par_u, gains, x)


def rfnn_backward_plain(coef_v, par_v, coef_u, par_u, gains, v, u, g):
    """The plain PyTorch version of kernel B5: ``(dcv, dcu, dg, dx)`` from
    the saved boundaries ``v``, ``u`` and the magnitudes' cotangent ``g``."""
    _check_rfnn_backward(coef_v, par_v, coef_u, par_u, gains, v, u, g)
    return ref.rfnn_linear_planes_bwd(coef_v, par_v, coef_u, par_u, gains,
                                      v, u, g)


_RFNN_FWD_ARGS = {"rfnn_fwd_launch": [_P, _P, _P, _P, _I, _P, _P, _I, _P,
                                      _I, _I, _P],
                  "rfnn_fwd_res_launch": [_P] * 6 + [_I, _P, _P, _I, _P, _I,
                                                     _I, _P]}
_RFNN_BWD_ARGS = {"rfnn_bwd_blocks": [_I, _I],
                  "rfnn_bwd_launch": [_P] * 5 + [_I, _P, _P, _I] + [_P] * 4
                  + [_I, _I, _I, _P]}


def launch_rfnn(coef_v, par_v, coef_u, par_u, gains, x, *,
                save_stages: bool = False):
    """Launch kernel B3 (``out``) or, with ``save_stages``, kernel B4
    (``(out, v, u)``) on the current stream (no autograd)."""
    _check_rfnn(coef_v, par_v, coef_u, par_u, gains, x)
    _on_card("rfnn", x)
    b, n = x.shape
    cv, cu = coef_v.shape[0], coef_u.shape[0]
    coef_v, par_v = coef_v.contiguous(), par_v.contiguous()
    coef_u, par_u = coef_u.contiguous(), par_u.contiguous()
    gains, x = gains.contiguous(), _dense(x)
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    v = torch.empty_like(x) if save_stages else None
    u = torch.empty_like(x) if save_stages else None
    if b > 0:  # a grid of 0 blocks is an invalid launch
        lib = _lib("rfnn_fwd", _RFNN_FWD_ARGS)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            tail = (coef_v.data_ptr(), par_v.data_ptr(), cv, coef_u.data_ptr(),
                    par_u.data_ptr(), cu, gains.data_ptr(), b, n, stream)
            if save_stages:
                err = lib.rfnn_fwd_res_launch(x.data_ptr(), out.data_ptr(),
                                              v.data_ptr(), u.data_ptr(), *tail)
            else:
                err = lib.rfnn_fwd_launch(x.data_ptr(), out.data_ptr(), *tail)
        name = "rfnn_fwd_res" if save_stages else "rfnn_fwd"
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                               f"(B={b}, n={n}, Cv={cv}, Cu={cu})")
        LAUNCHES[name] += 1
    return (out, v, u) if save_stages else out


def launch_rfnn_backward(coef_v, par_v, coef_u, par_u, gains, v, u, g):
    """Launch kernel B5 on the current stream: ``(dcv, dcu, dg, dx)`` from
    the saved boundaries and the magnitudes' cotangent (no autograd).

    Each block writes its batch-summed gradients into its own slice of a
    ``[blocks, (Cv + Cu + 1) * 8 * P]`` scratch and a second kernel sums the
    slices in block order: the three gradients are the same bits on every
    call.  They are views of one buffer.
    """
    _check_rfnn_backward(coef_v, par_v, coef_u, par_u, gains, v, u, g)
    _on_card("rfnn backward", v)
    b, n = v.shape
    p = n // 2
    cv, cu = coef_v.shape[0], coef_u.shape[0]
    coef_v, par_v = coef_v.contiguous(), par_v.contiguous()
    coef_u, par_u = coef_u.contiguous(), par_u.contiguous()
    gains, v, u, g = gains.contiguous(), _dense(v), _dense(u), _dense(g)
    total = (cv + cu + 1) * 8 * p
    # written whole by the reduce; zeros only when there is nothing to sum
    grads = (torch.empty if b > 0 else torch.zeros)(
        total, dtype=torch.float32, device=v.device)
    dx = torch.empty_like(v)
    if b > 0:  # nothing to sum and a 0-block grid is an invalid launch
        lib = _lib("rfnn_bwd", _RFNN_BWD_ARGS)
        with torch.cuda.device(v.device):
            blocks = lib.rfnn_bwd_blocks(b, n)
            if blocks <= 0:
                raise RuntimeError(f"rfnn_bwd_blocks failed: CUDA error "
                                   f"{-blocks}")
            partial = torch.empty((blocks, total), dtype=torch.float32,
                                  device=v.device)
            stream = torch.cuda.current_stream(v.device).cuda_stream
            err = lib.rfnn_bwd_launch(
                v.data_ptr(), u.data_ptr(), g.data_ptr(), coef_v.data_ptr(),
                par_v.data_ptr(), cv, coef_u.data_ptr(), par_u.data_ptr(), cu,
                gains.data_ptr(), partial.data_ptr(), grads.data_ptr(),
                dx.data_ptr(), b, n, blocks, stream)
        if err != 0:
            raise RuntimeError(f"rfnn_bwd launch failed: CUDA error {err} "
                               f"(B={b}, n={n}, Cv={cv}, Cu={cu}, "
                               f"blocks={blocks})")
        LAUNCHES["rfnn_bwd"] += 1
    dcv, dcu, dg = grads.split([cv * 8 * p, cu * 8 * p, 8 * p])
    return (dcv.view(cv, 8, p), dcu.view(cu, 8, p), dg.view(8, p), dx)


class _RfnnSweep(torch.autograd.Function):
    """The fused layer under autograd: B4 forward and B5 backward on a CUDA
    tensor, their plain versions on a CPU tensor.  Saves only the two stage
    boundaries (and the inputs); everything inside a mesh is rebuilt by the
    reversed sweeps."""

    @staticmethod
    def forward(ctx, coef_v, par_v, coef_u, par_u, gains, x):
        if x.device.type == "cuda":
            out, v, u = launch_rfnn(coef_v, par_v, coef_u, par_u, gains, x,
                                    save_stages=True)
        else:
            out, v, u = rfnn_forward_plain(coef_v, par_v, coef_u, par_u,
                                           gains, x)
        ctx.save_for_backward(coef_v, par_v, coef_u, par_u, gains, v, u)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        coef_v, par_v, coef_u, par_u, gains, v, u = ctx.saved_tensors
        if v.device.type == "cuda":
            dcv, dcu, dg, dx = launch_rfnn_backward(coef_v, par_v, coef_u,
                                                    par_u, gains, v, u, g)
        elif v.device.type == "cpu":
            dcv, dcu, dg, dx = rfnn_backward_plain(coef_v, par_v, coef_u,
                                                   par_u, gains, v, u, g)
        else:
            raise ValueError(f"no rfnn backward for {v.device} tensors")
        return dcv, None, dcu, None, dg, dx


def rfnn_forward(coef_v, par_v, coef_u, par_u, gains, x) -> torch.Tensor:
    """``|g2 * U (g1 * V x)|``, float32 ``[B, n]``.

    When a gradient is wanted (grad mode on and an input requires grad) it
    goes through B4 and, on the way back, B5; otherwise through B3, which
    writes no residuals (serving, programmed-matrix probes).  The choice is
    made here: inside ``autograd.Function.forward`` grad mode is off.  CPU
    tensors take the plain versions; any other device raises.
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rfnn_forward runs on cuda or cpu tensors, got "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (coef_v, coef_u, gains, x)):
        return _RfnnSweep.apply(coef_v, par_v, coef_u, par_u, gains, x)
    if x.device.type == "cuda":
        return launch_rfnn(coef_v, par_v, coef_u, par_u, gains, x)
    return rfnn_forward_plain(coef_v, par_v, coef_u, par_u, gains, x)[0]
