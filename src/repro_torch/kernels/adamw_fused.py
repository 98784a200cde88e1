"""The fused AdamW update on the card and its plain PyTorch version.

``update(opt, p, g, m, v, step, lr)`` applies one AdamW step to lists of
leaves: params ``p``, gradients ``g``, moments ``m`` and ``v``, the step
count after the update (``step``, int32 0-d) and the learning rate at it
(``lr``, a float or a 0-d tensor); ``opt`` is the
:class:`~repro_torch.optim.AdamW` whose ``b1``, ``b2``, ``eps``,
``weight_decay``, ``clip_norm`` and ``moment_dtype`` apply.  It returns
``(new_p, new_m, new_v, gnorm)``, new tensors all; the inputs stay as they
are.  The path follows what the leaves show:

- any leaf a ``DTensor`` (the ``parallel/`` training paths): the plain
  version, whose global norm DTensor's dispatch reduces across ranks;
- plain tensors on a CUDA device: :func:`launch`, the hand-written kernels
  of ``csrc/adamw_fused.cu`` (built at first use, see :mod:`cuda_build`),
  which raises on what they do not take; there is no fallback;
- otherwise (the CPU): :func:`update_plain`, which the CPU tests hold to
  the JAX package's AdamW.

The kernels replace no TPU kernel (XLA fuses the JAX package's update); the
source notes their bound and design.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from repro_torch.kernels import cuda_build

#: Launch counters: each incremented once per launch of its CUDA kernel,
#: nowhere else.  ``adamw_update`` rises by one a leaf an update.
LAUNCHES = {"adamw_sqnorm": 0, "adamw_finalize": 0, "adamw_update": 0}

_THREADS = 256   # threads a block (kThreads in the source)
_WAVES = 4       # blocks an SM in the grid-stride kernels
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    "adamw_sqnorm_launch": [_P, _L, _I, _P, _I, _P],
    "adamw_finalize_launch": [_P, _I, _P, _F, _F, _F, _I, _P, _P, _P],
    "adamw_update_launch": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P,
                            _P, _F, _F, _F, _F, _F, _F, _F, _I, _I, _I, _P],
}


def _has_dtensor(*groups) -> bool:
    # no DTensor exists before its module is imported, so a process that
    # never imported it skips the isinstance checks
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(t, mod.DTensor)
                                   for group in groups for t in group)


def update(opt, p, g, m, v, step, lr):
    """One AdamW step over leaf lists: the kernels for plain CUDA tensors,
    the plain version for DTensors and CPU tensors (module docstring)."""
    if _has_dtensor(p, g, m, v, [step]):
        return update_plain(opt, p, g, m, v, step, lr)
    if any(t.device.type == "cuda" for t in p):
        return launch(opt, p, g, m, v, step, lr)
    return update_plain(opt, p, g, m, v, step, lr)


def update_plain(opt, p, g, m, v, step, lr):
    """The plain PyTorch version: the update as separate tensor ops, on any
    device, DTensors included."""
    g = [t.to(torch.float32) for t in g]
    if opt.clip_norm > 0:
        gsq = torch.zeros((), dtype=torch.float32, device=step.device)
        for t in g:
            gsq = gsq + (t * t).sum()
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(opt.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            max=1.0)
        g = [t * scale for t in g]
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=step.device)

    b1, b2 = opt.b1, opt.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=step.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=step.device), stepf)
    new_p, new_m, new_v = [], [], []
    for pi, gi, mi, vi in zip(p, g, m, v):
        mf = mi.to(torch.float32) * b1 + (1 - b1) * gi
        vf = vi.to(torch.float32) * b2 + (1 - b2) * gi * gi
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + opt.eps)
        if opt.weight_decay:
            delta = delta + opt.weight_decay * pi.to(torch.float32)
        new_p.append((pi.to(torch.float32) - lr * delta).to(pi.dtype))
        new_m.append(mf.to(opt.moment_dtype))
        new_v.append(vf.to(opt.moment_dtype))
    return new_p, new_m, new_v, gnorm


def _check(opt, p, g, m, v) -> None:
    if not len(p) == len(g) == len(m) == len(v):
        raise ValueError(f"{len(p)} params, {len(g)} gradients and "
                         f"{len(m)}/{len(v)} moments")
    if opt.moment_dtype not in _DTYPES:
        raise ValueError(f"the fused AdamW keeps moments in float32 or "
                         f"bfloat16, not {opt.moment_dtype}")
    for i, (pi, gi, mi, vi) in enumerate(zip(p, g, m, v)):
        if pi.dtype not in _DTYPES or gi.dtype not in _DTYPES:
            raise ValueError(f"leaf {i}: the fused AdamW takes float32 or "
                             f"bfloat16 params and gradients, got "
                             f"{pi.dtype} and {gi.dtype}")
        if mi.dtype != opt.moment_dtype or vi.dtype != opt.moment_dtype:
            raise ValueError(f"leaf {i}: moments {mi.dtype}/{vi.dtype}, the "
                             f"optimizer's moment dtype is "
                             f"{opt.moment_dtype}")
        if not pi.shape == gi.shape == mi.shape == vi.shape:
            raise ValueError(f"leaf {i}: shapes {tuple(pi.shape)}, "
                             f"{tuple(gi.shape)}, {tuple(mi.shape)}, "
                             f"{tuple(vi.shape)} differ")
    devices = {t.device for group in (p, g, m, v) for t in group}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the fused AdamW runs on leaves on one CUDA "
                         f"device, got {sorted(map(str, devices))}")


def _bind(lib) -> None:
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int


def _blocks(n: int, sms: int) -> int:
    """The grid of a grid-stride launch over ``n`` elements (4 a thread a
    round): enough blocks for the work, at most ``_WAVES`` an SM."""
    return max(1, min(-(-n // (4 * _THREADS)), _WAVES * sms))


def _raise_on(err: int, name: str, n: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} (n={n})")


def launch(opt, p, g, m, v, step, lr):
    """The kernels on the current stream: with clipping, one
    ``adamw_sqnorm`` a leaf, then one ``adamw_finalize``, then one
    ``adamw_update`` a leaf (empty leaves launch nothing).  Raises on a
    dtype other than float32 and bfloat16 (moments: the optimizer's
    ``moment_dtype``), before anything launches, and on leaves that are not
    on one CUDA device.  A leaf that is not contiguous is copied to one that
    is.  Nothing here waits for the card."""
    _check(opt, p, g, m, v)
    dev = p[0].device
    p, g, m, v = ([t.contiguous() for t in group] for group in (p, g, m, v))
    step = step.to(device=dev, dtype=torch.int32)
    lr_dev = None
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError(f"the learning rate must be one value, got "
                             f"shape {tuple(lr.shape)}")
        lr_dev = lr.to(device=dev, dtype=torch.float32).reshape(())
    lib = cuda_build.load("adamw_fused")
    _bind(lib)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clipping = opt.clip_norm > 0
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    scalars = torch.empty(3, dtype=torch.float32, device=dev)
    bf = [[int(t.dtype == torch.bfloat16) for t in group]
          for group in (p, g, m)]
    new_p = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in p]
    new_m = [torch.empty(t.shape, dtype=opt.moment_dtype, device=dev)
             for t in p]
    new_v = [torch.empty(t.shape, dtype=opt.moment_dtype, device=dev)
             for t in p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        partial, n_partial = None, 0
        if clipping:
            grids = [_blocks(t.numel(), sms) if t.numel() else 0 for t in g]
            n_partial = sum(grids)
            partial = torch.empty(max(n_partial, 1), dtype=torch.float32,
                                  device=dev)
            at = partial.data_ptr()
            for i, (t, blocks) in enumerate(zip(g, grids)):
                if not blocks:
                    continue
                _raise_on(lib.adamw_sqnorm_launch(
                    t.data_ptr(), t.numel(), bf[1][i], at, blocks, stream),
                    "adamw_sqnorm", t.numel())
                LAUNCHES["adamw_sqnorm"] += 1
                at += 4 * blocks
        _raise_on(lib.adamw_finalize_launch(
            None if partial is None else partial.data_ptr(), n_partial,
            step.data_ptr(), opt.b1, opt.b2, opt.clip_norm, int(clipping),
            gnorm.data_ptr(), scalars.data_ptr(), stream),
            "adamw_finalize", n_partial)
        LAUNCHES["adamw_finalize"] += 1
        for i, n in enumerate(t.numel() for t in p):
            if not n:
                continue
            _raise_on(lib.adamw_update_launch(
                p[i].data_ptr(), g[i].data_ptr(), m[i].data_ptr(),
                v[i].data_ptr(), new_p[i].data_ptr(), new_m[i].data_ptr(),
                new_v[i].data_ptr(), n, bf[0][i], bf[1][i], bf[2][i],
                scalars.data_ptr(),
                None if lr_dev is None else lr_dev.data_ptr(),
                0.0 if lr_dev is not None else float(lr), opt.b1,
                1 - opt.b1, opt.b2, 1 - opt.b2, opt.eps, opt.weight_decay,
                int(clipping), int(bool(opt.weight_decay)),
                _blocks(n, sms), stream), "adamw_update", n)
            LAUNCHES["adamw_update"] += 1
    return new_p, new_m, new_v, gnorm
