"""Flash attention on Hopper: kernel B9 and its plain PyTorch version.

``flash_attention(q, k, v, causal=, bq=, bk=, scale=)`` computes
``softmax(q k^T * scale) v`` (``scale`` 0: ``1 / sqrt(hd)``) for q
``[B, H, Sq, hd]`` and k, v
``[B, H, Skv, hd]`` (KV heads already expanded to H), float32 or bfloat16,
with float32 math and the output in the input's dtype.  It keeps the JAX
package's signature and its ``ValueError`` when a length does not divide its
block; ``bq``/``bk`` were the TPU kernel's tiling and only shape that check
here (the CUDA kernel tiles 64 query rows by 64 or 32 keys itself).  The
kernel takes q, k, v by their strides with the last dim contiguous, so the
model's ``[B, S, H, hd]`` tensors pass as ``transpose(1, 2)`` views without
a copy, and its output takes q's layout.

On a CUDA tensor it launches the hand-written kernel ``csrc/flash_attn_fwd.cu``
(built for ``sm_90a`` at first use, see :mod:`cuda_build`), which replaces the
JAX package's Pallas TPU kernel ``repro/kernels/flash_attention.py: _kernel``;
on a CPU tensor it runs :func:`flash_attention_plain`, the dense-softmax twin
(``ref.flash_attention_ref``).  Any other device raises.  There is no fallback
from the kernel to its plain version.  Forward only, as the TPU kernel:
``flash_attention`` and ``launch`` raise ``ValueError`` when grad mode is on
and q, k or v requires grad, on either device (the kernel writes its output
through a raw pointer, so a gradient would silently stop there).  Training
uses ``attn_impl="xla"``; prefill, decode and evaluation run under
``torch.no_grad()``.

The kernel's design and its bound are noted in its source.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build, ref

#: Launch counter: incremented once per launch of the CUDA kernel, nowhere
#: else.  Proof that a run went through the kernel.
LAUNCHES = {"flash_attn_fwd": 0}

MAX_HEAD_DIM = 256
_BLOCK_Q = 64                  # the kernel's query rows per block
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
_STRIDES = ctypes.c_longlong * 12


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, S, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != hd:
        raise ValueError(f"k and v must be [{b}, {h}, Skv, {hd}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v must share a device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in [1, {MAX_HEAD_DIM}], got {hd}")


def _forward_only(q, k, v) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "the flash attention kernel B9 is forward-only, like the TPU "
            "kernel it replaces: it has no backward.  Train with "
            "attn_impl='xla'; run prefill, decode and evaluation under "
            "torch.no_grad()")


def kernel_strides(q, k, v, o) -> list[int]:
    """The batch, head and sequence strides (elements) of q, k, v and o, in
    the kernel's order.  Raises unless each one's last dim is contiguous:
    the kernel takes any other layout, e.g. the ``[B, S, H, hd]`` tensors
    of the model seen as ``[B, H, S, hd]`` through ``transpose(1, 2)``."""
    out = []
    for name, t in zip("qkvo", (q, k, v, o)):
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"the last dim of {name} must be contiguous "
                             f"(stride 1), got strides {tuple(t.stride())}")
        out.extend(t.stride()[:3])
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel (dense scores)."""
    _check(q, k, v)
    return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, scale: float = 0.0) -> torch.Tensor:
    """Launch kernel B9 on the current stream; q, k, v CUDA tensors with
    their last dim contiguous (raises otherwise), any other strides.  The
    output takes q's layout (``torch.empty_like``).  ``scale`` multiplies
    the scores (0: ``1 / sqrt(hd)``).  Raises under autograd (grad mode on
    and q, k or v requiring grad): B9 has no backward."""
    _check(q, k, v)
    _forward_only(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"the flash attention kernel runs on CUDA tensors, "
                         f"got {q.device}")
    b, h, sq, hd = q.shape
    skv = k.shape[2]
    o = torch.empty_like(q)
    strides = kernel_strides(q, k, v, o)
    if b * h * sq == 0:  # nothing to compute; a 0-block grid is invalid
        return o
    if skv == 0:
        raise ValueError("attention over zero keys is undefined")
    if -(-sq // _BLOCK_Q) * b * h >= 2**31:
        raise ValueError(f"B*H = {b * h} and Sq = {sq} exceed the kernel's "
                         "grid")
    lib = cuda_build.load("flash_attn_fwd")
    fn = lib.flash_attn_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 _STRIDES(*strides), b, h, sq, skv, hd, int(causal),
                 int(q.dtype == torch.bfloat16), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err} "
                           f"(B={b}, H={h}, Sq={sq}, Skv={skv}, hd={hd})")
    LAUNCHES["flash_attn_fwd"] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128, bk: int = 128,
                    scale: float = 0.0) -> torch.Tensor:
    """q, k, v: [B, H, S, hd] (KV heads pre-expanded to H) -> [B, H, Sq, hd],
    the scores times ``scale`` (0: ``1 / sqrt(hd)``).

    The kernel on a CUDA tensor, the plain version on a CPU tensor.  Raises
    ``ValueError`` when Sq or Skv does not divide ``min(bq, Sq)`` or
    ``min(bk, Skv)``, as the JAX package's kernel does, and under autograd
    (grad mode on and q, k or v requiring grad) on both devices: the kernel
    is forward-only, as the JAX package's (``jax.grad`` cannot pass it).
    """
    _check(q, k, v)
    _forward_only(q, k, v)
    sq, skv = q.shape[2], k.shape[2]
    bq_, bk_ = min(bq, sq), min(bk, skv)
    if (bq_ and sq % bq_) or (bk_ and skv % bk_):
        raise ValueError(f"seq lens ({sq},{skv}) must divide blocks "
                         f"({bq_},{bk_})")
    if q.device.type == "cuda":
        return launch(q, k, v, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                     f"{q.device}")
