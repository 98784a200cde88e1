"""A2, the rotary position embedding of q and k in one launch on the card.

``rope(q, k, positions, inv_freq)`` returns ``(q', k')``: q ``[B, S, Hq,
hd]`` and k ``[B, S, Hkv, hd]`` rotated by the angles ``positions x
inv_freq`` (int32 positions ``[S]`` or ``[B, S]``, decode's ``[B, 1]``
among them; float32 ``inv_freq`` ``[hd / 2]``), with autograd through a
backward that is the same kernel with the sine negated.  It launches the
hand-written kernel of ``csrc/rope_fused.cu`` (built at first use, see
:mod:`cuda_build`) and raises on what the kernel does not take; there is no
fallback.  The plain version is ``models/layers.py``'s ``rope_frequencies``
and ``apply_rope``, which ``layers.rope_qk`` runs for DTensors and CPU
tensors (see :func:`takes`) and which the CPU tests hold to the JAX
package.

The kernel replaces no TPU kernel (XLA fuses the JAX package's RoPE); the
source notes its bound, design and arithmetic.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from repro_torch.kernels import cuda_build

#: Launch counters: each incremented once per launch of the CUDA kernel in
#: that direction, nowhere else.  ``rope_fwd`` rises by one an attention
#: call, ``rope_bwd`` by one a call in the backward.
LAUNCHES = {"rope_fwd": 0, "rope_bwd": 0}
#: Calls of ``layers.rope_qk`` that took the plain version (DTensors, CPU).
PLAIN = {"rope_plain": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "rope_launch": [_P, _P, _P, _P, _P, _L, _L, _P, _L, _I, _I, _I, _I, _I,
                    _I, _P],
}


def takes(*tensors) -> bool:
    """Whether the kernel takes these tensors: none a ``DTensor`` (the
    ``parallel/`` paths) and all on a CUDA device."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is not None and any(isinstance(t, mod.DTensor) for t in tensors):
        return False
    return all(t.device.type == "cuda" for t in tensors)


def _check(q, k, positions, inv_freq) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be [B, S, heads, hd], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, s, _, hd = q.shape
    if k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"k must be [{b}, {s}, Hkv, {hd}], got "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise ValueError(f"q and k must both be float32, bfloat16 or "
                         f"float16, got {q.dtype} and {k.dtype}")
    if hd % 2:
        raise ValueError(f"the head dim must be even, got {hd}")
    if positions.dtype != torch.int32 or tuple(positions.shape) not in (
            (s,), (b, s)):
        raise ValueError(f"positions must be int32 [{s}] or [{b}, {s}], got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    if inv_freq.dtype != torch.float32 or tuple(inv_freq.shape) != (hd // 2,):
        raise ValueError(f"inv_freq must be float32 [{hd // 2}], got "
                         f"{inv_freq.dtype} {tuple(inv_freq.shape)}")
    if not (q.is_contiguous() and k.is_contiguous()):
        raise ValueError(f"q and k must be contiguous, got strides "
                         f"{q.stride()} and {k.stride()}")
    devices = {t.device for t in (q, k, positions, inv_freq)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the RoPE kernel runs on tensors on one CUDA "
                         f"device, got {sorted(map(str, devices))}")


def launch(q, k, positions, inv_freq, *, backward: bool = False):
    """One launch on the current stream: ``(q', k')``, new tensors, or with
    ``backward`` the vector-Jacobian product of the rotation at the
    gradients ``q``, ``k``.  Raises before anything launches on what the
    kernel does not take (``_check``).  Nothing here waits for the card."""
    _check(q, k, positions, inv_freq)
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    if q.numel() + k.numel() == 0:
        return q_out, k_out
    sb, ss = (0, positions.stride(0)) if positions.dim() == 1 else \
        positions.stride()
    lib = cuda_build.load("rope_fused")
    fn = lib.rope_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES["rope_launch"]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), q_out.data_ptr(),
                 k_out.data_ptr(), positions.data_ptr(), sb, ss,
                 inv_freq.data_ptr(), b * s, s, hq, hkv, hd,
                 _DTYPES[q.dtype], int(backward), stream)
    if err != 0:
        raise RuntimeError(f"rope_fused refused the call or its launch "
                           f"failed: CUDA error {err} (B={b}, S={s}, Hq={hq}, "
                           f"Hkv={hkv}, hd={hd})")
    LAUNCHES["rope_bwd" if backward else "rope_fwd"] += 1
    return q_out, k_out


class _Rope(torch.autograd.Function):
    """The forward launch; its backward, the launch with the sine negated,
    saves only the positions and ``inv_freq``."""

    @staticmethod
    def forward(ctx, q, k, positions, inv_freq):
        ctx.save_for_backward(positions, inv_freq)
        return launch(q, k, positions, inv_freq)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dq, dk):
        positions, inv_freq = ctx.saved_tensors
        dq, dk = launch(dq.contiguous(), dk.contiguous(), positions,
                        inv_freq, backward=True)
        return dq, dk, None, None


#: ``rope(q, k, positions, inv_freq) -> (q', k')``: one launch, and under
#: autograd one launch of the backward.
rope = _Rope.apply
