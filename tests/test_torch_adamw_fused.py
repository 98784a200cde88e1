"""The fused AdamW update (``kernels/adamw_fused.py``, ``csrc/adamw_fused.cu``).

On the CPU: ``AdamW.update`` never loads the CUDA library, the kernel path
refuses what it does not take before anything launches, a DTensor tree
takes the plain version, and the ctypes signatures match the source's C
interface.  The ``gpu`` tests hold the kernels to the plain version on the
same card tensors and skip without a card; like every card test they need
no JAX (run them with ``pytest --noconftest -m gpu`` where it is absent).

Tolerances on the card: without clipping the kernels do the plain
version's float32 operations in its order with round-to-nearest
intrinsics, so p, m and v may differ by at most 2 ulp of their dtype (bit
equality is what is expected).  With clipping the global norm is summed in
another order, so ``gnorm`` agrees within 1e-6 relative and each float32
leaf within 1e-6 of its largest magnitude; a bfloat16 output may also sit
one bfloat16 step away, where that difference flipped its final rounding.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication,
)

from repro_torch.kernels import adamw_fused, cuda_build  # noqa: E402
from repro_torch.optim import AdamW, OptState, cosine_schedule  # noqa: E402

_SIZES = (1, 3, 4097)
_CELL_LEAF = (20, 2048, 8192)  # granite-3-2b's stacked MLP weight
_CLIPS = {"off": 0.0, "on": 1e6, "active": 0.5}
_BF = torch.bfloat16


def _no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the CUDA library {name} was loaded")

    monkeypatch.setattr(cuda_build, "load", refuse)


def _tree(rng, dtype=torch.float32):
    return {"a": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32))
            .to(dtype),
            "b": {"c": torch.from_numpy(rng.normal(size=(5,))
                                        .astype(np.float32)).to(dtype)}}


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"clip_norm": 1.0, "weight_decay": 0.1},
    {"clip_norm": 0.0, "lr": cosine_schedule(1e-2, 2, 10),
     "moment_dtype": _BF, "grad_compression": True},
])
def test_adamw_update_on_cpu_never_loads_the_library(monkeypatch, kw):
    """CPU leaves take the plain version: three steps run with the
    library's loader raising, no launch counted, and match the plain
    version called directly."""
    _no_library(monkeypatch)
    before = dict(adamw_fused.LAUNCHES)
    rng = np.random.default_rng(3)
    opt = AdamW(**kw)
    params = _tree(rng)
    state = opt.init(params)
    for _ in range(3):
        grads = opt.compress_grads(_tree(rng))
        step = state.step + 1
        lr = opt.lr(step) if callable(opt.lr) else opt.lr
        leaves = [torch.utils._pytree.tree_leaves(t)
                  for t in (params, grads, state.m, state.v)]
        want = adamw_fused.update_plain(opt, *leaves, step, lr)
        params, state, gnorm = opt.update(params, grads, state)
        got = [torch.utils._pytree.tree_leaves(t)
               for t in (params, state.m, state.v)] + [gnorm]
        for g, w in zip(got[:3], want[:3]):
            for a, b in zip(g, w):
                assert torch.equal(a, b)
        assert torch.equal(got[3], want[3])
    assert int(state.step) == 3
    assert adamw_fused.LAUNCHES == before


@pytest.mark.parametrize("case", [
    "float16_moments", "float64_params", "float16_grads", "moment_mismatch",
    "shape_mismatch", "cpu_leaves"])
def test_fused_launch_rejects_what_it_cannot_take(monkeypatch, case):
    """The kernel path raises ValueError before the library is loaded or
    anything launches: dtypes other than float32 and bfloat16 (moments: the
    optimizer's ``moment_dtype``), unequal shapes and leaves off the card."""
    _no_library(monkeypatch)
    before = dict(adamw_fused.LAUNCHES)
    opt = AdamW(moment_dtype=torch.float16 if case == "float16_moments"
                else torch.float32)
    p = torch.zeros(8, dtype=torch.float64 if case == "float64_params"
                    else torch.float32)
    g = torch.zeros(8, dtype=torch.float16 if case == "float16_grads"
                    else torch.float32)
    m = torch.zeros(8, dtype=_BF if case == "moment_mismatch"
                    else opt.moment_dtype)
    v = torch.zeros(9 if case == "shape_mismatch" else 8,
                    dtype=opt.moment_dtype)
    match = {"float16_moments": "moments in float32 or bfloat16",
             "float64_params": "float32 or bfloat16 params",
             "float16_grads": "float32 or bfloat16 params",
             "moment_mismatch": "moment dtype",
             "shape_mismatch": "shapes",
             "cpu_leaves": "one CUDA device"}[case]
    with pytest.raises(ValueError, match=match):
        adamw_fused.launch(opt, [p], [g], [m], [v],
                           torch.ones((), dtype=torch.int32), 1e-3)
    assert adamw_fused.LAUNCHES == before


def test_dtensor_tree_takes_the_plain_path(monkeypatch, tmp_path):
    """Leaves laid out as DTensors (one gloo rank, a sharded and a
    replicated leaf) take the plain version, never the kernel path, and
    give its numbers on the local tensors."""
    _no_library(monkeypatch)

    def refuse(*args):
        raise AssertionError("the kernel path took DTensor leaves")

    monkeypatch.setattr(adamw_fused, "launch", refuse)
    rng = np.random.default_rng(5)
    params, grads = _tree(rng), _tree(rng)
    grads["a"] *= 3.0  # a norm above the clip
    opt = AdamW(lr=0.05, clip_norm=1.0, weight_decay=0.1)
    state = opt.init(params)
    want_p, want_s, want_n = opt.update(params, grads, state)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))

        def lay(tree):
            return {"a": distribute_tensor(tree["a"], mesh, [Shard(0)]),
                    "b": {"c": distribute_tensor(tree["b"]["c"], mesh,
                                                 [Replicate()])}}

        dstate = OptState(step=state.step, m=lay(state.m), v=lay(state.v))
        assert adamw_fused._has_dtensor(
            torch.utils._pytree.tree_leaves(lay(params)))
        with implicit_replication():
            got_p, got_s, got_n = opt.update(lay(params), lay(grads), dstate)
        pairs = zip(torch.utils._pytree.tree_leaves((got_p, got_s.m,
                                                     got_s.v)),
                    torch.utils._pytree.tree_leaves((want_p, want_s.m,
                                                     want_s.v)))
        for got, want in pairs:
            torch.testing.assert_close(got.to_local(), want, rtol=0,
                                       atol=1e-7)
        torch.testing.assert_close(got_n.full_tensor(), want_n, rtol=1e-6,
                                   atol=0)
    finally:
        dist.destroy_process_group()


def test_ctypes_signatures_match_the_source():
    """Each ``extern "C"`` launch function of ``csrc/adamw_fused.cu`` takes
    the arguments the wrapper declares, in order: a mismatch would only
    show on the card, as a cut pointer or a shifted float."""
    src = (cuda_build.CSRC / "adamw_fused.cu").read_text()
    body = src[src.index('extern "C" {'):]
    found = dict(re.findall(r"int (adamw_\w+_launch)\(([^)]*)\)", body))
    assert set(found) == set(adamw_fused._SIGNATURES)
    kinds = {ctypes_type: kind for kind, ctypes_type in (
        ("ptr", adamw_fused._P), ("int", adamw_fused._I),
        ("float", adamw_fused._F), ("long long", adamw_fused._L))}
    for name, args in found.items():
        declared = []
        for arg in (a.strip() for a in args.split(",")):
            if "*" in arg:
                declared.append("ptr")
            elif arg.startswith("long long"):
                declared.append("long long")
            else:
                declared.append(arg.split()[0])
        assert declared == [kinds[t] for t in adamw_fused._SIGNATURES[name]]


def test_grid_sizes_follow_the_leaf_and_the_card():
    """One block for a tiny leaf; enough 4-element rounds for the work;
    never more than four blocks an SM."""
    assert adamw_fused._blocks(1, 132) == 1
    assert adamw_fused._blocks(4 * 256, 132) == 1
    assert adamw_fused._blocks(4 * 256 + 1, 132) == 2
    assert adamw_fused._blocks(20 * 2048 * 8192, 132) == 4 * 132


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused AdamW has no CPU mode")
    return torch.device("cuda")


def _ordered(t):
    """Each value's place on the line of its dtype's floats (ulp steps)."""
    if t.dtype == torch.float32:
        i, mask = t.view(torch.int32).to(torch.int64), 0x7FFFFFFF
    else:
        i, mask = t.view(torch.int16).to(torch.int64), 0x7FFF
    return torch.where(i < 0, -(i & mask), i)


def _ulps(a, b) -> int:
    return int((_ordered(a) - _ordered(b)).abs().max()) if a.numel() else 0


def _leaves(shapes, dtypes, step, gen, dev, gscale=1.0):
    """p, g, m, v leaf lists: normal params and gradients, moments as a
    fresh state has them at step 1 and drawn otherwise (v >= 0)."""
    p_dt, g_dt, mv_dt = dtypes
    out = ([], [], [], [])
    for shape in shapes:
        def normal(dtype, s=1.0):
            return (torch.randn(shape, generator=gen, device=dev) * s
                    ).to(dtype)

        out[0].append(normal(p_dt))
        out[1].append(normal(g_dt, gscale))
        if step == 1:
            out[2].append(torch.zeros(shape, dtype=mv_dt, device=dev))
            out[3].append(torch.zeros(shape, dtype=mv_dt, device=dev))
        else:
            out[2].append(normal(mv_dt, 0.1))
            out[3].append(normal(torch.float32, 0.1).square().to(mv_dt))
    return out


def _compare(clip, got, want):
    (gp, gm, gv, gn), (wp, wm, wv, wn) = got, want
    if clip == "off":
        assert float(gn) == float(wn) == 0.0
    else:
        assert abs(float(gn) - float(wn)) <= 1e-6 * abs(float(wn))
    for g_leaves, w_leaves in ((gp, wp), (gm, wm), (gv, wv)):
        for a, b in zip(g_leaves, w_leaves):
            assert a.dtype == b.dtype and a.shape == b.shape
            if clip == "off":
                assert _ulps(a, b) <= 2
                continue
            near = (a.float() - b.float()).abs() <= \
                1e-6 * float(b.float().abs().max())
            if a.dtype == _BF:
                near |= (_ordered(a) - _ordered(b)).abs() <= 1
            assert bool(near.all())


def _run_both(opt, p, g, m, v, step0, dev):
    """The kernel path through ``AdamW.update`` and the plain version on
    the same card tensors, the inputs checked unchanged and the update
    launches counted (one a leaf)."""
    copies = [[t.clone() for t in group] for group in (p, g, m, v)]
    keys = [f"l{i}" for i in range(len(p))]
    state = OptState(step=torch.full((), step0, dtype=torch.int32,
                                     device=dev),
                     m=dict(zip(keys, m)), v=dict(zip(keys, v)))
    before = adamw_fused.LAUNCHES["adamw_update"]
    new_p, new_s, gnorm = opt.update(dict(zip(keys, p)), dict(zip(keys, g)),
                                     state)
    torch.cuda.synchronize()
    assert adamw_fused.LAUNCHES["adamw_update"] == before + len(p)
    assert int(new_s.step) == step0 + 1 and int(state.step) == step0
    step = state.step + 1
    lr = opt.lr(step) if callable(opt.lr) else opt.lr
    want = adamw_fused.update_plain(opt, p, g, m, v, step, lr)
    for group, copy in zip((p, g, m, v), copies):
        for t, c in zip(group, copy):
            assert torch.equal(t, c)
    got = ([new_p[k] for k in keys], [new_s.m[k] for k in keys],
           [new_s.v[k] for k in keys], gnorm)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("clip", list(_CLIPS))
@pytest.mark.parametrize("dtypes", [
    (p, g, mv) for p in (torch.float32, _BF) for g in (torch.float32, _BF)
    for mv in (torch.float32, _BF)], ids=lambda d: "-".join(
        "bf16" if t == _BF else "f32" for t in d))
def test_fused_adamw_matches_plain_on_card(cuda_device, dtypes, clip):
    """Leaves of 1, 3 and 4097 elements and one 4097-element view 4 bytes
    off alignment (the scalar loop), at weight decay 0 and 0.1, a float
    and a schedule's learning rate, steps 1 and 1000."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    for wd in (0.0, 0.1):
        for lr in (3e-4, cosine_schedule(3e-4, 10, 2000)):
            for step in (1, 1000):
                opt = AdamW(lr=lr, weight_decay=wd, clip_norm=_CLIPS[clip],
                            moment_dtype=dtypes[2])
                p, g, m, v = _leaves([(n,) for n in _SIZES + (4098,)],
                                     dtypes, step, gen, cuda_device)
                p[-1], g[-1], m[-1], v[-1] = (t[1:] for t in
                                              (p[-1], g[-1], m[-1], v[-1]))
                got, want = _run_both(opt, p, g, m, v, step - 1,
                                      cuda_device)
                _compare(clip, got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("clip", ["off", "active"])
def test_fused_adamw_matches_plain_at_the_cell_leaf_on_card(cuda_device,
                                                            clip):
    """granite-3-2b's 20 x 2048 x 8192 MLP weight in float32 with float32
    moments, weight decay 0.1, steps 1 and 1000; with clipping the kernels
    give the same bits twice."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    opt = AdamW(lr=3e-4, weight_decay=0.1, clip_norm=_CLIPS[clip])
    f32 = (torch.float32,) * 3
    for step in (1, 1000):
        p, g, m, v = _leaves([_CELL_LEAF], f32, step, gen, cuda_device,
                             gscale=1e-4)
        got, want = _run_both(opt, p, g, m, v, step - 1, cuda_device)
        _compare(clip, got, want)
        del want
        if clip == "active":
            again = adamw_fused.update(opt, p, g, m, v,
                                       torch.full((), step, dtype=torch.int32,
                                                  device=cuda_device), 3e-4)
            for a, b in zip((*got[:3], [got[3]]), (*again[:3], [again[3]])):
                assert all(torch.equal(x, y) for x, y in zip(a, b))
        del p, g, m, v, got
        torch.cuda.empty_cache()


@pytest.mark.gpu
def test_fused_adamw_makes_no_synchronising_call_on_card(cuda_device):
    """``AdamW.update`` on card tensors, with clipping, weight decay and a
    schedule, runs under ``set_sync_debug_mode("error")``; the plain
    version's bias-correction copies would not."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    opt = AdamW(lr=cosine_schedule(3e-4, 10, 2000), weight_decay=0.1,
                clip_norm=1.0)
    p, g, m, v = _leaves([(n,) for n in _SIZES], (torch.float32,) * 3, 1000,
                         gen, cuda_device)
    params, grads = dict(enumerate(p)), dict(enumerate(g))
    state = OptState(step=torch.full((), 999, dtype=torch.int32,
                                     device=cuda_device),
                     m=dict(enumerate(m)), v=dict(enumerate(v)))
    opt.update(params, grads, state)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            params, state, _ = opt.update(params, grads, state)
        with pytest.raises(RuntimeError):
            adamw_fused.update_plain(opt, p, g, m, v, state.step,
                                     opt.lr(state.step))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(state.step) == 1002
