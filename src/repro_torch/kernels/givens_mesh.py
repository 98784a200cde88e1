"""The mesh kernels on Hopper (forward B1, backward B2), the fused analog
linear layer's kernels (B3, B4, backward B5), the deep tile grid's kernels
(B6, B7, backward B8) and their plain PyTorch versions.

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

B1 and B2 take a register path for n in :data:`REG_WIDTHS` (one thread a
row, the mesh's cells staged once a block, no barrier between columns;
B2 sums a column's gradient terms over a warp by shuffles and, when one
block covers the batch, writes ``dcoef`` in its one launch) and the
shared-memory sweep otherwise.  :func:`mesh_fwd_plan` and
:func:`mesh_bwd_plan` report the launch for a shape on the current card
(cached per batch, width, columns and card); :func:`mesh_fwd_layout` and
:func:`mesh_bwd_layout` compute it from the card's SM count.  B5 and B8
take register paths for the same widths (B8 for at most 32 tiles): each
cell's inverse computed once a block, identity runs skipped, gradient
terms summed over a block's rows and written once, one kernel a call
where one block covers the batch; one thread a row (B5 up to 256 rows) or
a (row, tile) (B8 on a grid), n / 2 lanes a row for B5 above 256 rows and
for B8 on one tile.  :func:`rfnn_bwd_plan` / :func:`deepgrid_bwd_plan`
report their launches, :func:`rfnn_bwd_layout` /
:func:`deepgrid_bwd_layout` compute them.  B3 and B4 take a register path
for the same widths too: both meshes' cells staged once a block with their
identity slots marked and skipped, n / 2 lanes a row up to
:data:`RFNN_FWD_LANES_BELOW` rows and one thread a row from there
(:func:`rfnn_fwd_plan`, :func:`rfnn_fwd_layout`).

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

``deepgrid_forward(coef_v, par_v, coef_u, par_u, gains, x, detect_last=)``
is the deep tile grid: L layers of a (To x Ti) grid of tiles, each tile
``g2 * U (g1 * V (g0 * x_i))``, each row summing its Ti tiles, the rows
re-detected (|.|) into the next layer's input tiles; the last layer's rows
come out as magnitudes (``detect_last``) or complex, ``[B, To n]``.
Coefficients are float32 ``[L, To, Ti, C, 8, P]``, parities int32
``[L, To, Ti, C]``, gains float32 ``[L, To, Ti, 12, P]`` (rows 0-3 g0, 4-7
g1, 8-11 g2), x complex64 ``[B, Ti n]``.  On a CUDA tensor it runs
``csrc/deepgrid_fwd.cu``: kernel B6 (``deepgrid_kernel``) when no input
needs a gradient, else B7 (``deepgrid_fwd_kernel``), which also saves every
tile's post-V and post-U boundaries, and on the way back B8
(``csrc/deepgrid_bwd.cu``, ``deepgrid_bwd_kernel``).  On a CPU tensor it
runs the plain versions in :mod:`ref`.
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
            "rfnn_bwd": 0, "deepgrid_fwd": 0, "deepgrid_fwd_res": 0,
            "deepgrid_bwd": 0}

#: The kernels index rows with int32.
_MAX_BATCH = 2**31 - 256

#: Mesh widths B1 and B2 run on their register path (one thread a row).
REG_WIDTHS = (2, 4, 8, 16, 32)
_REG_ROWS_MAX = 256        # csrc/mesh_sweep.cuh: kRegRowsMax
_MAX_SHARED = 232448       # shared bytes a block may use on sm_90
_DEEP_REG_THREADS = 256    # csrc/deepgrid_bwd.cu: kRegThreads
_DEEP_MAX_STAGES = 8       # csrc/deepgrid_bwd.cu: kMaxStages
_DEEP_BWD_THREADS = 512    # csrc/deepgrid_bwd.cu: kBwdThreads (general path)
#: Bytes of per-block gradient slices a B8 call may write (its blocks walk
#: more row tiles beyond it).
DEEP_SLICE_BUDGET = 128 << 20


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


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = {"mesh_fwd_launch": [_P] * 4 + [_I] * 5 + [_L, _P]}
_BWD_ARGS = {"mesh_bwd_occupancy": [_I, _I, _I, _L],
             "mesh_bwd_launch": [_P] * 7 + [_I] * 6 + [_L, _P]}


# ---------------------------------------------------------------------------
# launch plans of B1 and B2
# ---------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _staged_bytes(n: int, n_cols: int, words: int) -> int:
    """csrc/mesh_sweep.cuh: staged_cell_bytes: ``words`` float4 a cell, then
    the parities padded to 16 bytes."""
    return n_cols * (n // 2) * words * 16 + _ceil_div(n_cols, 4) * 16


def _reg_rows(batch: int, sms: int) -> int:
    """Rows (threads) of a register-path block: one block holds a batch of
    up to 256 rows; above, ceil(B / SMs) rows rounded up to a warp, at most
    256."""
    if batch <= _REG_ROWS_MAX:
        return 32 * _ceil_div(batch, 32)
    return min(_REG_ROWS_MAX, 32 * _ceil_div(_ceil_div(batch, sms), 32))


def mesh_fwd_layout(batch: int, n: int, n_cols: int, sms: int) -> dict:
    """How B1 launches for ``batch`` rows of an n-channel, ``n_cols``-column
    mesh on a card of ``sms`` SMs: ``register_path`` (1 for n in
    :data:`REG_WIDTHS` when the staged cells fit a block), ``rows`` a block,
    ``threads`` a block, ``blocks`` and dynamic ``shared_bytes`` a block
    (one kernel a call)."""
    if batch < 1:
        raise ValueError(f"a plan needs batch >= 1, got {batch}")
    smem = _staged_bytes(n, n_cols, 2)
    if n in REG_WIDTHS and smem <= _MAX_SHARED:
        rows = _reg_rows(batch, sms)
        return {"register_path": 1, "rows": rows, "threads": rows,
                "blocks": _ceil_div(batch, rows), "shared_bytes": smem}
    rows = max(1, 128 // (n // 2))   # mesh_sweep.cuh: rows_per_tile
    return {"register_path": 0, "rows": rows, "threads": 128,
            "blocks": _ceil_div(batch, rows), "shared_bytes": rows * n * 8}


def mesh_bwd_layout(batch: int, n: int, n_cols: int, sms: int,
                    occupancy) -> dict:
    """How B2 launches (keys as :func:`mesh_fwd_layout`'s, and ``kernels`` a
    call); ``occupancy(reg, n, threads, shared_bytes)`` gives the resident
    blocks an SM holds.  The
    register path takes up to 256 rows a block (fewer warps where their
    accumulators would not fit), and its blocks walk the batch's tiles, at
    most one wave of them: a single block writes ``dcoef`` itself (one
    kernel), more write slices that a second kernel sums."""
    if batch < 1:
        raise ValueError(f"a plan needs batch >= 1, got {batch}")
    if n in REG_WIDTHS:
        def smem(rows):   # mesh_bwd.cu: reg_shared_bytes
            return _staged_bytes(n, n_cols, 4) + (rows // 32) * n_cols * 16 * n

        rows = _reg_rows(batch, sms)
        while rows > 32 and smem(rows) > _MAX_SHARED:
            rows -= 32
        if smem(rows) <= _MAX_SHARED:
            tiles = _ceil_div(batch, rows)
            blocks = 1 if tiles == 1 else min(
                tiles, max(1, sms * occupancy(1, n, rows, smem(rows))))
            return {"register_path": 1, "rows": rows, "threads": rows,
                    "blocks": blocks, "shared_bytes": smem(rows),
                    "kernels": 1 if blocks == 1 else 2}
    rows = max(1, 128 // (n // 2))
    smem = rows * n * 32              # mesh_sweep.cuh: reverse_shared_bytes
    blocks = min(_ceil_div(batch, rows),
                 max(1, sms * occupancy(0, n, 128, smem)))
    return {"register_path": 0, "rows": rows, "threads": 128,
            "blocks": blocks, "shared_bytes": smem, "kernels": 2}


_PLANS: dict = {}
_SMS: dict = {}


def _sms(index: int) -> int:
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def _lib_occupancy(name: str, args: dict, *shape) -> int:
    """Resident blocks an SM holds, from ``<name>_occupancy(*shape)`` of the
    kernel library ``name``."""
    per_sm = getattr(_lib(name, args), f"{name}_occupancy")(*shape)
    if per_sm < 0:
        raise RuntimeError(f"{name}_occupancy failed: CUDA error {-per_sm} "
                           f"(arguments {shape})")
    return per_sm


def _occupancy(reg: int, n: int, threads: int, smem: int) -> int:
    return _lib_occupancy("mesh_bwd", _BWD_ARGS, reg, n, threads, smem)


def _rfnn_occupancy(reg: int, n: int, lanes: int, threads: int,
                    smem: int) -> int:
    return _lib_occupancy("rfnn_bwd", _RFNN_BWD_ARGS, reg, n, lanes, threads,
                          smem)


def _deep_occupancy(reg: int, n: int, tiles: int, detect_last: int,
                    threads: int, smem: int) -> int:
    return _lib_occupancy("deepgrid_bwd", _DEEP_BWD_ARGS, reg, n, tiles,
                          detect_last, threads, smem)


def _cached_plan(kind: str, index: int, batch: int, n: int, *shape) -> dict:
    """The plan of B1 (``kind`` "fwd"), B2 ("bwd"; ``shape`` (C,)), B3/B4
    ("rfnn_fwd"; (Cv, Cu)), B5 ("rfnn_bwd"; (Cv, Cu)) or B8 ("deep_bwd";
    (L, To, Ti, C, detect_last)) on card ``index``, computed once per kind,
    card, batch and shape."""
    key = (kind, index, batch, n, *shape)
    if key not in _PLANS:
        sms = _sms(index)
        if kind == "fwd":
            _PLANS[key] = mesh_fwd_layout(batch, n, *shape, sms)
        elif kind == "rfnn_fwd":
            _PLANS[key] = rfnn_fwd_layout(batch, n, *shape, sms)
        elif kind == "bwd":
            _PLANS[key] = mesh_bwd_layout(batch, n, *shape, sms, _occupancy)
        elif kind == "rfnn_bwd":
            _PLANS[key] = rfnn_bwd_layout(batch, n, *shape, sms,
                                          _rfnn_occupancy)
        else:
            _PLANS[key] = deepgrid_bwd_layout(batch, n, *shape, sms,
                                              _deep_occupancy)
    return _PLANS[key]


def mesh_fwd_plan(batch: int, n: int, n_cols: int) -> dict:
    """B1's launch for ``batch`` rows on the current card
    (:func:`mesh_fwd_layout`)."""
    return dict(_cached_plan("fwd", torch.cuda.current_device(), batch, n,
                             n_cols))


def mesh_bwd_plan(batch: int, n: int, n_cols: int) -> dict:
    """B2's launch for ``batch`` rows on the current card
    (:func:`mesh_bwd_layout`)."""
    return dict(_cached_plan("bwd", torch.cuda.current_device(), batch, n,
                             n_cols))


def launch(coef: torch.Tensor, parity: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no autograd)."""
    _check(coef, parity, x)
    _on_card("mesh", x)
    b, n = x.shape
    c = coef.shape[0]
    coef, parity, x = coef.contiguous(), parity.contiguous(), _dense(x)
    y = torch.empty_like(x)
    if b == 0:  # a grid of 0 blocks is an invalid launch
        return y
    fn = _lib("mesh_fwd", _FWD_ARGS).mesh_fwd_launch
    with torch.cuda.device(x.device):
        plan = _cached_plan("fwd", x.device.index, b, n, c)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), coef.data_ptr(),
                 parity.data_ptr(), b, n, c, plan["register_path"],
                 plan["rows"], plan["shared_bytes"], stream)
    if err != 0:
        raise RuntimeError(f"mesh_fwd launch failed: CUDA error {err} "
                           f"(B={b}, n={n}, C={c}, plan {plan})")
    LAUNCHES["mesh_fwd"] += 1
    return y


def launch_backward(coef: torch.Tensor, parity: torch.Tensor, y: torch.Tensor,
                    g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B2 on the current stream: ``(dcoef, dx)`` from the
    forward's output ``y`` and the cotangent ``g`` (no autograd).

    One block covering the batch writes ``dcoef`` itself; otherwise each
    block writes its batch-summed coefficient gradient into its own slice
    of a ``[blocks, C, 8, P]`` scratch, and a second kernel sums the slices
    in block order.  Either way ``dcoef`` is the same bits on every call.
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
        plan = _cached_plan("bwd", y.device.index, b, n, c)
        partial = torch.empty((plan["blocks"], c, 8, n // 2),
                              dtype=torch.float32, device=y.device) \
            if plan["kernels"] == 2 else None
        dcoef = torch.empty_like(coef)
        dx = torch.empty_like(y)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.mesh_bwd_launch(
            y.data_ptr(), g.data_ptr(), coef.data_ptr(), parity.data_ptr(),
            None if partial is None else partial.data_ptr(), dcoef.data_ptr(),
            dx.data_ptr(), b, n, c, plan["register_path"], plan["rows"],
            plan["blocks"], plan["shared_bytes"], stream)
    if err != 0:
        raise RuntimeError(f"mesh_bwd launch failed: CUDA error {err} "
                           f"(B={b}, n={n}, C={c}, plan {plan})")
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


_RFNN_FWD_ARGS = {"rfnn_fwd_launch": [_P] * 4 + [_I, _P, _P, _I, _P]
                  + [_I] * 5 + [_L, _P],
                  "rfnn_fwd_res_launch": [_P] * 6 + [_I, _P, _P, _I, _P]
                  + [_I] * 5 + [_L, _P]}
_RFNN_BWD_ARGS = {"rfnn_bwd_occupancy": [_I] * 4 + [_L],
                  "rfnn_bwd_launch": [_P] * 5 + [_I, _P, _P, _I] + [_P] * 4
                  + [_I] * 6 + [_L, _P]}


def _rfnn_fwd_smem(n: int, cv: int, cu: int) -> int:
    """csrc/rfnn_fwd.cu: reg_shared_bytes: both meshes' cells, the gains,
    the mark words."""
    p, cols = n // 2, cv + cu
    return cols * p * 32 + 32 * p + _ceil_div(cols, 4) * 16


#: B3/B4 take n / 2 lanes a row below this batch, one thread a row from it
#: (tools/deepgrid_times.py: both layouts at phase 9's batches, PERF.md §6).
RFNN_FWD_LANES_BELOW = 16384


def rfnn_fwd_register_plan(batch: int, n: int, cv: int, cu: int, sms: int,
                           lanes: int) -> dict:
    """B3/B4's register-path launch with ``lanes`` a row (1, or n / 2 for
    n >= 4): keys as :func:`rfnn_fwd_layout`'s.  One thread a row takes
    B1's rows a block; n / 2 lanes a row take ceil(B / SMs) rows a block,
    rounded up to a warp's rows, at least 128 threads (they stage the
    paper's meshes in one round) and at most 256."""
    if batch < 1:
        raise ValueError(f"a plan needs batch >= 1, got {batch}")
    if n not in REG_WIDTHS or lanes not in (1, n // 2) \
            or (lanes > 1 and n < 4):
        raise ValueError(f"no register path at n={n} with {lanes} lanes a "
                         "row")
    if lanes == 1:
        rows = _reg_rows(batch, sms)
    else:
        per_warp = 32 // lanes
        rows = min(_REG_ROWS_MAX // lanes, max(
            128 // lanes,
            per_warp * _ceil_div(_ceil_div(batch, sms), per_warp)))
    return {"register_path": 1, "rows": rows, "lanes": lanes,
            "threads": rows * lanes, "blocks": _ceil_div(batch, rows),
            "shared_bytes": _rfnn_fwd_smem(n, cv, cu)}


def rfnn_fwd_layout(batch: int, n: int, cv: int, cu: int, sms: int) -> dict:
    """How B3/B4 launch for ``batch`` rows of an n-channel layer with
    ``cv``/``cu`` V/U columns on a card of ``sms`` SMs: ``register_path``
    (1 for n in :data:`REG_WIDTHS` when both meshes' staged cells fit a
    block), ``rows`` a block, ``lanes`` a row, ``threads`` a block,
    ``blocks`` and dynamic ``shared_bytes`` a block (one kernel a call).
    The register path spreads a row over n / 2 lanes below
    :data:`RFNN_FWD_LANES_BELOW` rows (n >= 4) and takes one thread a row
    from there (:func:`rfnn_fwd_register_plan`)."""
    if batch < 1:
        raise ValueError(f"a plan needs batch >= 1, got {batch}")
    if n in REG_WIDTHS and _rfnn_fwd_smem(n, cv, cu) <= _MAX_SHARED:
        lanes = n // 2 if n >= 4 and batch < RFNN_FWD_LANES_BELOW else 1
        return rfnn_fwd_register_plan(batch, n, cv, cu, sms, lanes)
    return rfnn_fwd_general_plan(batch, n)


def rfnn_fwd_general_plan(batch: int, n: int) -> dict:
    """B3/B4's general-path launch (any even n; keys as
    :func:`rfnn_fwd_layout`'s): a tile of 128 / P rows a block in shared
    memory."""
    if batch < 1:
        raise ValueError(f"a plan needs batch >= 1, got {batch}")
    rows = max(1, 128 // (n // 2))   # mesh_sweep.cuh: rows_per_tile
    return {"register_path": 0, "rows": rows, "lanes": 1, "threads": 128,
            "blocks": _ceil_div(batch, rows), "shared_bytes": rows * n * 8}


def rfnn_fwd_plan(batch: int, n: int, cv: int, cu: int) -> dict:
    """B3/B4's launch for ``batch`` rows on the current card
    (:func:`rfnn_fwd_layout`)."""
    return dict(_cached_plan("rfnn_fwd", torch.cuda.current_device(), batch,
                             n, cv, cu))


def _rfnn_bwd_smem(n: int, cv: int, cu: int, warps: int) -> int:
    """csrc/rfnn_bwd.cu: reg_shared_bytes: both meshes' cells and inverses,
    the gains, the mark words, each warp's accumulator."""
    p, cols = n // 2, cv + cu
    return (cols * p * 64 + 32 * p + _ceil_div(cols, 4) * 16
            + warps * (cols + 1) * 8 * p * 4)


def _rfnn_lane_smem(n: int, cv: int, cu: int, rows: int) -> int:
    """csrc/rfnn_bwd.cu: lane_shared_bytes: both meshes' cells and
    inverses, the gains, the mark words, each row's padded terms."""
    p, cols = n // 2, cv + cu
    return (cols * p * 64 + 32 * p + _ceil_div(cols, 4) * 16
            + rows * ((cols + 1) * 8 * p + 4) * 4)


def rfnn_bwd_layout(batch: int, n: int, cv: int, cu: int, sms: int,
                    occupancy) -> dict:
    """How B5 launches for ``batch`` rows of an n-channel layer with
    ``cv``/``cu`` V/U columns on a card of ``sms`` SMs (keys as
    :func:`mesh_bwd_layout`'s, and ``lanes`` a row);
    ``occupancy(reg, n, lanes, threads, shared_bytes)`` gives the resident
    blocks an SM holds.  As B2: the register path takes one thread a row
    and up to 256 rows a block (fewer warps where their accumulators would
    not fit); a single block writes the gradients itself (one kernel), more
    write slices that a second kernel sums.  Above 256 rows (n >= 4) it
    takes n / 2 lanes a row and ceil(B / SMs) rows a block, rounded up to a
    warp's rows."""
    if batch < 1:
        raise ValueError(f"a plan needs batch >= 1, got {batch}")
    if n in REG_WIDTHS and n > 2 and batch > _REG_ROWS_MAX:
        p = n // 2
        per_warp = 32 // p
        rows = min(_REG_ROWS_MAX // p,
                   per_warp * _ceil_div(_ceil_div(batch, sms), per_warp))
        while rows > per_warp and _rfnn_lane_smem(n, cv, cu, rows) \
                > _MAX_SHARED:
            rows -= per_warp
        smem = _rfnn_lane_smem(n, cv, cu, rows)
        if smem <= _MAX_SHARED:
            blocks = min(_ceil_div(batch, rows), max(1, sms * occupancy(
                1, n, p, rows * p, smem)))
            return {"register_path": 1, "rows": rows, "threads": rows * p,
                    "lanes": p, "blocks": blocks, "shared_bytes": smem,
                    "kernels": 2}
    if n in REG_WIDTHS:
        rows = _reg_rows(batch, sms)
        while rows > 32 and _rfnn_bwd_smem(n, cv, cu, rows // 32) \
                > _MAX_SHARED:
            rows -= 32
        smem = _rfnn_bwd_smem(n, cv, cu, rows // 32)
        if smem <= _MAX_SHARED:
            tiles = _ceil_div(batch, rows)
            blocks = 1 if tiles == 1 else min(
                tiles, max(1, sms * occupancy(1, n, 1, rows, smem)))
            return {"register_path": 1, "rows": rows, "threads": rows,
                    "lanes": 1, "blocks": blocks, "shared_bytes": smem,
                    "kernels": 1 if blocks == 1 else 2}
    rows = max(1, 128 // (n // 2))
    smem = rows * n * 32              # mesh_sweep.cuh: reverse_shared_bytes
    blocks = min(_ceil_div(batch, rows),
                 max(1, sms * occupancy(0, n, 1, 128, smem)))
    return {"register_path": 0, "rows": rows, "threads": 128, "lanes": 1,
            "blocks": blocks, "shared_bytes": smem, "kernels": 2}


def rfnn_bwd_plan(batch: int, n: int, cv: int, cu: int) -> dict:
    """B5's launch for ``batch`` rows on the current card
    (:func:`rfnn_bwd_layout`)."""
    return dict(_cached_plan("rfnn_bwd", torch.cuda.current_device(), batch,
                             n, cv, cu))


def launch_rfnn(coef_v, par_v, coef_u, par_u, gains, x, *,
                save_stages: bool = False, plan: dict | None = None):
    """Launch kernel B3 (``out``) or, with ``save_stages``, kernel B4
    (``(out, v, u)``) on the current stream (no autograd).  ``plan``: the
    launch, by default :func:`rfnn_fwd_plan`'s for this shape; the kernel
    refuses one it cannot run."""
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
            if plan is None:
                plan = _cached_plan("rfnn_fwd", x.device.index, b, n, cv, cu)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            tail = (coef_v.data_ptr(), par_v.data_ptr(), cv, coef_u.data_ptr(),
                    par_u.data_ptr(), cu, gains.data_ptr(), b, n,
                    plan["register_path"], plan["rows"], plan["lanes"],
                    plan["shared_bytes"], stream)
            if save_stages:
                err = lib.rfnn_fwd_res_launch(x.data_ptr(), out.data_ptr(),
                                              v.data_ptr(), u.data_ptr(), *tail)
            else:
                err = lib.rfnn_fwd_launch(x.data_ptr(), out.data_ptr(), *tail)
        name = "rfnn_fwd_res" if save_stages else "rfnn_fwd"
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                               f"(B={b}, n={n}, Cv={cv}, Cu={cu}, plan {plan})")
        LAUNCHES[name] += 1
    return (out, v, u) if save_stages else out


def launch_rfnn_backward(coef_v, par_v, coef_u, par_u, gains, v, u, g):
    """Launch kernel B5 on the current stream: ``(dcv, dcu, dg, dx)`` from
    the saved boundaries and the magnitudes' cotangent (no autograd).

    One block covering the batch writes the gradients itself; otherwise
    each block writes its batch-summed gradients into its own slice of a
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
    # written whole by the kernels; zeros only when there is nothing to sum
    grads = (torch.empty if b > 0 else torch.zeros)(
        total, dtype=torch.float32, device=v.device)
    dx = torch.empty_like(v)
    if b > 0:  # nothing to sum and a 0-block grid is an invalid launch
        lib = _lib("rfnn_bwd", _RFNN_BWD_ARGS)
        with torch.cuda.device(v.device):
            plan = _cached_plan("rfnn_bwd", v.device.index, b, n, cv, cu)
            partial = torch.empty((plan["blocks"], total), dtype=torch.float32,
                                  device=v.device) \
                if plan["kernels"] == 2 else None
            stream = torch.cuda.current_stream(v.device).cuda_stream
            err = lib.rfnn_bwd_launch(
                v.data_ptr(), u.data_ptr(), g.data_ptr(), coef_v.data_ptr(),
                par_v.data_ptr(), cv, coef_u.data_ptr(), par_u.data_ptr(), cu,
                gains.data_ptr(),
                None if partial is None else partial.data_ptr(),
                grads.data_ptr(), dx.data_ptr(), b, n, plan["register_path"],
                plan["rows"], plan["lanes"], plan["blocks"],
                plan["shared_bytes"], stream)
        if err != 0:
            raise RuntimeError(f"rfnn_bwd launch failed: CUDA error {err} "
                               f"(B={b}, n={n}, Cv={cv}, Cu={cu}, "
                               f"plan {plan})")
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


# ---------------------------------------------------------------------------
# the deep tile grid: B6 / B7 forward, B8 backward
# ---------------------------------------------------------------------------

def _check_deep(coef_v, par_v, coef_u, par_u, gains, x) -> None:
    if coef_v.dim() != 6 or coef_v.dtype != torch.float32 \
            or coef_v.shape[4] != 8:
        raise ValueError(f"coef_v must be float32 [L, To, Ti, C, 8, P], got "
                         f"{coef_v.dtype} {tuple(coef_v.shape)}")
    n_layers, to, ti, c, _, p = coef_v.shape
    n = 2 * p
    if coef_u.shape != coef_v.shape or coef_u.dtype != torch.float32:
        raise ValueError(f"coef_u must be float32 {tuple(coef_v.shape)}, got "
                         f"{coef_u.dtype} {tuple(coef_u.shape)}")
    for name, par in (("par_v", par_v), ("par_u", par_u)):
        if par.shape != (n_layers, to, ti, c) or par.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 {(n_layers, to, ti, c)}, "
                             f"got {par.dtype} {tuple(par.shape)}")
    if gains.shape != (n_layers, to, ti, 12, p) \
            or gains.dtype != torch.float32:
        raise ValueError(f"gains must be float32 {(n_layers, to, ti, 12, p)}, "
                         f"got {gains.dtype} {tuple(gains.shape)}")
    if n_layers > 1 and to != ti:
        raise ValueError(f"a {n_layers}-layer grid needs To == Ti, got "
                         f"{to} x {ti}")
    if p < 1 or min(n_layers, to, ti, c) < 1:
        raise ValueError(f"empty grid {tuple(coef_v.shape)}")
    if x.dim() != 2 or x.dtype != torch.complex64 or x.shape[1] != ti * n:
        raise ValueError(f"x must be complex64 [B, {ti * n}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not all(t.device == x.device
               for t in (coef_v, par_v, coef_u, par_u, gains)):
        raise ValueError("coefficients, parities, gains and x must share a "
                         "device")


def _check_deep_backward(coef_v, par_v, coef_u, par_u, gains, x, sv, su, g,
                         detect_last) -> None:
    _check_deep(coef_v, par_v, coef_u, par_u, gains, x)
    n_layers, to, ti, _, _, p = coef_v.shape
    shape = (n_layers, x.shape[0], to, ti, 2 * p)
    for name, t in (("sv", sv), ("su", su)):
        if t.shape != shape or t.dtype != torch.complex64 \
                or t.device != x.device:
            raise ValueError(f"{name} must be complex64 {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    want = torch.float32 if detect_last else torch.complex64
    if g.shape != (x.shape[0], to * 2 * p) or g.dtype != want \
            or g.device != x.device:
        raise ValueError(f"cotangent must be {want} "
                         f"{(x.shape[0], to * 2 * p)} on {x.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")


def deepgrid_forward_plain(coef_v, par_v, coef_u, par_u, gains, x, *,
                           detect_last: bool = True):
    """The plain PyTorch version of kernels B6/B7: ``(out, sv, su)``, the
    last layer's rows and every tile's post-V and post-U boundaries."""
    _check_deep(coef_v, par_v, coef_u, par_u, gains, x)
    return ref.deep_grid_planes(coef_v, par_v, coef_u, par_u, gains, x,
                                detect_last=detect_last)


def deepgrid_backward_plain(coef_v, par_v, coef_u, par_u, gains, x, sv, su,
                            g, *, detect_last: bool = True):
    """The plain PyTorch version of kernel B8: ``(dcv, dcu, dg, dx)``."""
    _check_deep_backward(coef_v, par_v, coef_u, par_u, gains, x, sv, su, g,
                         detect_last)
    return ref.deep_grid_planes_bwd(coef_v, par_v, coef_u, par_u, gains, x,
                                    sv, su, g, detect_last=detect_last)


_DEEP_FWD_ARGS = {"deepgrid_fwd_launch": [_P] * 9 + [_I] * 8 + [_P],
                  "deepgrid_fwd_plan": [_I] * 7 + [ctypes.POINTER(_I)]}
_PLAN_KEYS = ("register_path", "rows", "blocks", "threads", "shared_bytes",
              "chunk_columns", "stages")
_DEEP_BWD_ARGS = {"deepgrid_bwd_occupancy": [_I] * 5 + [_L],
                  "deepgrid_bwd_launch": [_P] * 12 + [_I] * 13 + [_L, _P]}


def _deep_bwd_smem(n: int, n_layers: int, to: int, ti: int, rows: int,
                   kcap: int, stages: int) -> int:
    """csrc/deepgrid_bwd.cu: reg_shared_bytes (BwdLayout): the landing
    buffers, the staged cells, the marks, every layer's gains, then for a
    grid the column and gain sums and the rows' exchange buffers, for one
    tile each row's column and gain terms."""
    tiles = to * ti
    pars = _ceil_div(tiles * kcap, 4) * 4
    floats = (stages * (tiles * (kcap * 4 * n + (8 if tiles > 1 else 0))
                        + pars)
              + 4 * tiles * (2 * kcap * n + 1) + pars
              + n_layers * tiles * (6 * n + 4))
    if tiles == 1:
        return 4 * (floats + rows * (kcap * 4 * n + 4 + 6 * n + 4))
    floats += tiles * (kcap * 4 * n + 6 * n)
    return 4 * floats + 8 * rows * (tiles * n + 2 * max(to, ti) * n)


def deepgrid_bwd_layout(batch: int, n: int, n_layers: int, to: int, ti: int,
                        n_cols: int, detect_last: bool, sms: int,
                        occupancy) -> dict:
    """How B8 launches for ``batch`` rows of an (L, To, Ti, C, n) grid on a
    card of ``sms`` SMs: ``register_path``, ``rows`` a block, ``threads``
    a block, ``blocks``, dynamic ``shared_bytes`` a block, ``kernels`` a
    call, the staged ``chunk_columns`` and landing ``stages`` (0 on the
    general path) and the bytes of one gradient slice (``slice_bytes``);
    ``occupancy(reg, n, tiles, detect_last, threads, shared_bytes)`` gives
    the resident blocks an SM holds.

    The register path (n in :data:`REG_WIDTHS`, at most 32 tiles) takes,
    for a grid, 8 rows a block, one thread a (row, tile); for one tile n / 2
    lanes a row, whole warps, as many rows as cover the batch up to 256
    threads (above that ceil(B / SMs) rows rounded up to a warp's).  It
    stages as many columns a chunk as fit beside two landing buffers (more
    buffers, up to 8, where whole meshes fit).  A block a row tile, capped
    at one wave and at :data:`DEEP_SLICE_BUDGET` bytes of slices (its
    blocks then walk row tiles); one block writes the gradients itself (one
    kernel), more write slices that a second kernel sums."""
    if batch < 1:
        raise ValueError(f"a plan needs batch >= 1, got {batch}")
    tiles, p = to * ti, n // 2
    slice_bytes = 4 * n_layers * tiles * (2 * n_cols * 8 * p + 12 * p)
    budget = max(1, DEEP_SLICE_BUDGET // slice_bytes)
    if n in REG_WIDTHS and 8 * tiles <= _DEEP_REG_THREADS:
        if tiles == 1:
            per_warp = 32 // p                # rows a warp, p lanes a row
            most = _DEEP_REG_THREADS // p
            want = batch if batch <= most else _ceil_div(batch, sms)
            rows = min(most, per_warp * _ceil_div(want, per_warp))
            threads = rows * p
        else:
            rows = 8
            threads = _ceil_div(rows * tiles, 32) * 32
        kcap = n_cols
        stages = min(_DEEP_MAX_STAGES, 2 * n_layers)

        def smem():
            return _deep_bwd_smem(n, n_layers, to, ti, rows, kcap, stages)

        while stages > 2 and smem() > _MAX_SHARED:
            stages -= 1
        while kcap > 1 and smem() > _MAX_SHARED:
            kcap -= 1
        if smem() <= _MAX_SHARED:
            row_tiles = _ceil_div(batch, rows)
            blocks = 1 if row_tiles == 1 else min(
                row_tiles, budget, max(1, sms * occupancy(
                    1, n, tiles, int(detect_last), threads, smem())))
            return {"register_path": 1, "rows": rows, "threads": threads,
                    "blocks": blocks, "shared_bytes": smem(),
                    "kernels": 1 if blocks == 1 else 2,
                    "chunk_columns": kcap, "stages": stages,
                    "slice_bytes": slice_bytes}
    rows = min(64, max(1, _DEEP_BWD_THREADS // (tiles * p)))
    smem = rows * (32 * tiles * n + 16 * max(to, ti) * n)
    if smem > _MAX_SHARED:
        raise ValueError(f"no block of B8's general path fits shared memory "
                         f"(n={n}, {to}x{ti} tiles: {smem} bytes a row)")
    blocks = min(_ceil_div(batch, rows), budget, max(1, sms * occupancy(
        0, n, tiles, int(detect_last), _DEEP_BWD_THREADS, smem)))
    return {"register_path": 0, "rows": rows, "threads": _DEEP_BWD_THREADS,
            "blocks": blocks, "shared_bytes": smem, "kernels": 2,
            "chunk_columns": 0, "stages": 0, "slice_bytes": slice_bytes}


def deepgrid_bwd_plan(batch: int, n: int, n_layers: int, to: int, ti: int,
                      n_cols: int, detect_last: bool = True) -> dict:
    """B8's launch for ``batch`` rows on the current card
    (:func:`deepgrid_bwd_layout`)."""
    return dict(_cached_plan("deep_bwd", torch.cuda.current_device(), batch,
                             n, n_layers, to, ti, n_cols, bool(detect_last)))


def deepgrid_fwd_plan(batch: int, n: int, n_layers: int, to: int, ti: int,
                      n_cols: int, save_stages: bool = False) -> dict:
    """How kernel B6 (or, with ``save_stages``, B7) launches for ``batch``
    rows of an (L, To, Ti, C, n) grid on the current card: ``register_path``
    (1 for n in {2, 4, 8, 16, 32} and grids whose block fits, else 0),
    ``rows`` a block (R), ``blocks``, ``threads`` a block, dynamic
    ``shared_bytes`` a block, ``chunk_columns`` staged at a time and the
    ring's ``stages`` (0 on the general path).  The plan depends on the
    shape and the card's SM count alone."""
    if batch < 1:
        raise ValueError(f"a plan needs batch >= 1, got {batch}")
    plan = (_I * len(_PLAN_KEYS))()
    fn = _lib("deepgrid_fwd", _DEEP_FWD_ARGS).deepgrid_fwd_plan
    err = fn(batch, n, n_layers, to, ti, n_cols, int(save_stages), plan)
    if err != 0:
        raise RuntimeError(f"deepgrid_fwd_plan failed: CUDA error {err} "
                           f"(B={batch}, n={n}, L={n_layers}, To={to}, "
                           f"Ti={ti}, C={n_cols})")
    return dict(zip(_PLAN_KEYS, plan))


def launch_deepgrid(coef_v, par_v, coef_u, par_u, gains, x, *,
                    detect_last: bool = True, save_stages: bool = False):
    """Launch kernel B6 (``out``) or, with ``save_stages``, kernel B7
    (``(out, sv, su)``) on the current stream (no autograd)."""
    _check_deep(coef_v, par_v, coef_u, par_u, gains, x)
    _on_card("deepgrid", x)
    n_layers, to, ti, c, _, p = coef_v.shape
    b, n = x.shape[0], 2 * p
    coef_v, par_v = coef_v.contiguous(), par_v.contiguous()
    coef_u, par_u = coef_u.contiguous(), par_u.contiguous()
    gains, x = gains.contiguous(), _dense(x)
    out = torch.empty((b, to * n), device=x.device, dtype=(
        torch.float32 if detect_last else torch.complex64))
    stages = (n_layers, b, to, ti, n)
    sv = torch.empty(stages, dtype=x.dtype, device=x.device) \
        if save_stages else None
    su = torch.empty_like(sv) if save_stages else None
    if b > 0:  # a grid of 0 blocks is an invalid launch
        fn = _lib("deepgrid_fwd", _DEEP_FWD_ARGS).deepgrid_fwd_launch
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), out.data_ptr(),
                     sv.data_ptr() if save_stages else None,
                     su.data_ptr() if save_stages else None,
                     coef_v.data_ptr(), par_v.data_ptr(), coef_u.data_ptr(),
                     par_u.data_ptr(), gains.data_ptr(), b, n, n_layers, to,
                     ti, c, int(save_stages), int(detect_last), stream)
        name = "deepgrid_fwd_res" if save_stages else "deepgrid_fwd"
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                               f"(B={b}, n={n}, L={n_layers}, To={to}, "
                               f"Ti={ti}, C={c})")
        LAUNCHES[name] += 1
    return (out, sv, su) if save_stages else out


def launch_deepgrid_backward(coef_v, par_v, coef_u, par_u, gains, x, sv, su,
                             g, *, detect_last: bool = True):
    """Launch kernel B8 on the current stream: ``(dcv, dcu, dg, dx)`` from
    the input, the saved boundaries and the output's cotangent (no
    autograd).

    One block covering the batch writes the gradients itself; otherwise
    each block writes its batch-summed gradients into its own slice of a
    ``[blocks, L To Ti (2 C 8 P + 12 P)]`` scratch and a second kernel sums
    the slices in block order: the three gradients are the same bits on
    every call.  They are views of one buffer.
    """
    _check_deep_backward(coef_v, par_v, coef_u, par_u, gains, x, sv, su, g,
                         detect_last)
    _on_card("deepgrid backward", x)
    n_layers, to, ti, c, _, p = coef_v.shape
    b, n = x.shape[0], 2 * p
    coef_v, par_v = coef_v.contiguous(), par_v.contiguous()
    coef_u, par_u = coef_u.contiguous(), par_u.contiguous()
    gains, x = gains.contiguous(), _dense(x)
    sv, su, g = _dense(sv), _dense(su), _dense(g)
    coef_n = n_layers * to * ti * c * 8 * p
    gain_n = n_layers * to * ti * 12 * p
    # written whole by the kernels; zeros only when there is nothing to sum
    grads = (torch.empty if b > 0 else torch.zeros)(
        2 * coef_n + gain_n, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    if b > 0:  # nothing to sum and a 0-block grid is an invalid launch
        lib = _lib("deepgrid_bwd", _DEEP_BWD_ARGS)
        with torch.cuda.device(x.device):
            plan = _cached_plan("deep_bwd", x.device.index, b, n, n_layers,
                                to, ti, c, bool(detect_last))
            partial = torch.empty((plan["blocks"], grads.numel()),
                                  dtype=torch.float32, device=x.device) \
                if plan["kernels"] == 2 else None
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.deepgrid_bwd_launch(
                x.data_ptr(), sv.data_ptr(), su.data_ptr(), g.data_ptr(),
                coef_v.data_ptr(), par_v.data_ptr(), coef_u.data_ptr(),
                par_u.data_ptr(), gains.data_ptr(),
                None if partial is None else partial.data_ptr(),
                grads.data_ptr(), dx.data_ptr(), b, n, n_layers, to, ti, c,
                int(detect_last), plan["register_path"], plan["rows"],
                plan["threads"], plan["blocks"], plan["chunk_columns"],
                plan["stages"], plan["shared_bytes"], stream)
        if err != 0:
            raise RuntimeError(f"deepgrid_bwd launch failed: CUDA error {err} "
                               f"(B={b}, n={n}, L={n_layers}, To={to}, "
                               f"Ti={ti}, C={c}, plan {plan})")
        LAUNCHES["deepgrid_bwd"] += 1
    dcv, dcu, dg = grads.split([coef_n, coef_n, gain_n])
    return (dcv.view(coef_v.shape), dcu.view(coef_u.shape),
            dg.view(gains.shape), dx)


class _DeepGridSweep(torch.autograd.Function):
    """The deep grid under autograd: B7 forward and B8 backward on a CUDA
    tensor, their plain versions on a CPU tensor.  Saves the input and the
    stage boundaries; every layer boundary's rows are rebuilt from them."""

    @staticmethod
    def forward(ctx, coef_v, par_v, coef_u, par_u, gains, x, detect_last):
        if x.device.type == "cuda":
            out, sv, su = launch_deepgrid(coef_v, par_v, coef_u, par_u, gains,
                                          x, detect_last=detect_last,
                                          save_stages=True)
        else:
            out, sv, su = deepgrid_forward_plain(
                coef_v, par_v, coef_u, par_u, gains, x,
                detect_last=detect_last)
        ctx.detect_last = detect_last
        ctx.save_for_backward(coef_v, par_v, coef_u, par_u, gains, x, sv, su)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        coef_v, par_v, coef_u, par_u, gains, x, sv, su = ctx.saved_tensors
        args = (coef_v, par_v, coef_u, par_u, gains, x, sv, su, g)
        if x.device.type == "cuda":
            dcv, dcu, dg, dx = launch_deepgrid_backward(
                *args, detect_last=ctx.detect_last)
        elif x.device.type == "cpu":
            dcv, dcu, dg, dx = deepgrid_backward_plain(
                *args, detect_last=ctx.detect_last)
        else:
            raise ValueError(f"no deepgrid backward for {x.device} tensors")
        return dcv, None, dcu, None, dg, dx, None


def deepgrid_forward(coef_v, par_v, coef_u, par_u, gains, x, *,
                     detect_last: bool = True) -> torch.Tensor:
    """The deep grid's last-layer rows, ``[B, To n]``: float32 magnitudes
    (``detect_last``) or complex64.

    When a gradient is wanted (grad mode on and an input requires grad) it
    goes through B7 and, on the way back, B8; otherwise through B6, which
    writes no residuals (serving, evaluation).  CPU tensors take the plain
    versions; any other device raises.
    """
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"deepgrid_forward runs on cuda or cpu tensors, got "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (coef_v, coef_u, gains, x)):
        return _DeepGridSweep.apply(coef_v, par_v, coef_u, par_u, gains, x,
                                    detect_last)
    if x.device.type == "cuda":
        return launch_deepgrid(coef_v, par_v, coef_u, par_u, gains, x,
                               detect_last=detect_last)
    return deepgrid_forward_plain(coef_v, par_v, coef_u, par_u, gains, x,
                                  detect_last=detect_last)[0]
