"""A2, the RoPE kernel (``kernels/rope_fused.py``, ``csrc/rope_fused.cu``),
and its dispatch (``models/layers.py`` ``rope_qk``).

On the CPU: CPU tensors and DTensors take the plain version, counted in
``rope_fused.PLAIN`` and never loading the CUDA library; the kernel path
refuses what it does not take before anything launches; the ctypes
signature matches the source's C interface; the Python-float base gives the
old tensor base's bits.  The ``gpu`` tests hold the kernel to the plain
version on the same card tensors (bit equality is what is expected: the
kernel does the plain version's float32 operations in its order, and
``cosf``/``sinf`` are what ``torch.cos``/``torch.sin`` call; each test
prints how many outputs differ and holds them to one ulp of the output
dtype), its backward to autograd through the plain version, counts one
launch an attention call each way, and checks that nothing inside
``attn.rope`` waits for the card.  Like every card test they need no JAX
(run them with ``pytest --noconftest -m gpu`` where it is absent).
"""

import contextlib
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import Replicate, distribute_tensor  # noqa: E402
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication,
)

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import cuda_build, rope_fused  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402

_BF = torch.bfloat16
_CELL_LENGTHS = (512, 1024, 2048, 4032)   # granite-3-2b's benchmark cells


def _no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the CUDA library {name} was loaded")

    monkeypatch.setattr(cuda_build, "load", refuse)


def _qk(shape_q, hkv, dtype=torch.float32, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    b, s, _, hd = shape_q
    q = torch.randn(shape_q, generator=gen, device=device).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=gen, device=device).to(dtype)
    return q, k


def _plain(cfg, q, k, positions):
    cos, sin = layers.rope_frequencies(cfg, positions)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)


def _cfg(head_dim=16, theta=10000.0):
    return dataclasses.replace(configs.get_reduced("granite-3-2b"),
                               head_dim=head_dim, rope_theta=theta)


def _counts():
    return {**rope_fused.LAUNCHES, **rope_fused.PLAIN}


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("positions", ["seq", "rows", "decode"])
def test_cpu_tensors_take_the_plain_path(monkeypatch, positions):
    """``rope_qk`` on CPU tensors: the plain version's numbers, one plain
    call counted, no launch and no library loaded; prefill's [S] positions,
    per-row [B, S] and decode's [B, 1]."""
    _no_library(monkeypatch)
    cfg = _cfg()
    s = 1 if positions == "decode" else 7
    q, k = _qk((3, s, 4, 16), 2)
    pos = {"seq": torch.arange(s, dtype=torch.int32),
           "rows": torch.randint(0, 4096, (3, s), dtype=torch.int32),
           "decode": torch.tensor([[5], [900], [4031]], dtype=torch.int32)
           }[positions]
    before = _counts()
    got = layers.rope_qk(cfg, q, k, pos)
    want = _plain(cfg, q, k, pos)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _counts() == {**before, "rope_plain": before["rope_plain"] + 1}


def test_a_cpu_model_runs_every_attention_call_plain(monkeypatch):
    """A forward and backward of a small RoPE model on the CPU counts one
    plain call a layer and launches nothing."""
    _no_library(monkeypatch)
    cfg = dataclasses.replace(configs.get_reduced("granite-3-2b"),
                              dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 9),
                        generator=torch.Generator().manual_seed(2))
    before = _counts()
    live = torch.utils._pytree.tree_map(
        lambda t: t.detach().requires_grad_(True), params)
    loss, _ = model.loss(live, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    loss.backward()
    assert _counts() == {**before,
                         "rope_plain": before["rope_plain"] + cfg.n_layers}


def test_dtensor_inputs_take_the_plain_path(monkeypatch, tmp_path):
    """q, k and positions laid out as DTensors (one gloo rank) take the
    plain version, never the kernel path, and give its numbers on the
    local tensors."""
    _no_library(monkeypatch)

    def refuse(*args):
        raise AssertionError("the kernel path took DTensors")

    monkeypatch.setattr(rope_fused, "rope", refuse)
    cfg = _cfg()
    q, k = _qk((2, 5, 4, 16), 2, seed=3)
    pos = torch.arange(5, dtype=torch.int32)
    want = _plain(cfg, q, k, pos)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        dq, dk = (distribute_tensor(t, mesh, [Replicate()]) for t in (q, k))
        assert not rope_fused.takes(dq, dk, pos)
        before = _counts()
        with implicit_replication():
            got = layers.rope_qk(cfg, dq, dk, pos)
        assert _counts() == {**before,
                             "rope_plain": before["rope_plain"] + 1}
        for g, w in zip(got, want):
            assert torch.equal(g.to_local(), w)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", [
    "odd_head_dim", "positions_length", "positions_batch", "positions_int64",
    "non_contiguous_q", "float64", "dtype_mismatch", "k_shape",
    "inv_freq_shape", "cpu_tensors"])
def test_launch_refuses_what_it_cannot_take(monkeypatch, case):
    """The kernel path raises ValueError before the library is loaded or
    anything launches."""
    _no_library(monkeypatch)
    hd = 15 if case == "odd_head_dim" else 16
    q, k = _qk((2, 6, 4, hd), 2,
               dtype=torch.float64 if case == "float64" else _BF)
    if case == "dtype_mismatch":
        k = k.float()
    if case == "k_shape":
        k = k[:, :5].contiguous()
    if case == "non_contiguous_q":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    pos = {"positions_length": torch.arange(5, dtype=torch.int32),
           "positions_batch": torch.zeros((3, 6), dtype=torch.int32),
           "positions_int64": torch.arange(6)}.get(
               case, torch.arange(6, dtype=torch.int32))
    inv = layers.rope_inv_freq(2 * hd if case == "inv_freq_shape" else hd,
                               10000.0)
    match = {"odd_head_dim": "head dim must be even",
             "positions_length": "positions must be",
             "positions_batch": "positions must be",
             "positions_int64": "positions must be",
             "non_contiguous_q": "contiguous",
             "float64": "float32, bfloat16 or float16",
             "dtype_mismatch": "float32, bfloat16 or float16",
             "k_shape": "k must be",
             "inv_freq_shape": "inv_freq must be",
             "cpu_tensors": "one CUDA device"}[case]
    before = _counts()
    with pytest.raises(ValueError, match=match):
        rope_fused.launch(q, k, pos, inv)
    assert _counts() == before


def test_ctypes_signatures_match_the_source():
    """Each ``extern "C"`` launch function of ``csrc/rope_fused.cu`` takes
    the arguments the wrapper declares, in order: a mismatch would only
    show on the card, as a cut pointer or a shifted int."""
    src = (cuda_build.CSRC / "rope_fused.cu").read_text()
    body = src[src.index('extern "C" {'):]
    found = dict(re.findall(r"int (rope_\w*launch)\(([^)]*)\)", body))
    assert set(found) == set(rope_fused._SIGNATURES)
    kinds = {ctypes_type: kind for kind, ctypes_type in (
        ("ptr", rope_fused._P), ("int", rope_fused._I),
        ("long long", rope_fused._L))}
    for name, args in found.items():
        declared = []
        for arg in (a.strip() for a in args.split(",")):
            if "*" in arg:
                declared.append("ptr")
            elif arg.startswith("long long"):
                declared.append("long long")
            else:
                declared.append(arg.split()[0])
        assert declared == [kinds[t] for t in rope_fused._SIGNATURES[name]]


@pytest.mark.parametrize("theta", [10000.0, 500000.0, 1e6, 12345.678])
def test_python_float_base_gives_the_tensor_bases_bits(theta):
    """``rope_inv_freq``'s Python-float base gives, bit for bit, what the
    base copied to the device as a float32 tensor gave, at every head dim
    of the registered configs and a few more."""
    dims = {c.head_dim for c in map(configs.get_config, configs.list_archs())}
    for hd in sorted(dims | {2, 16, 80, 256}):
        half = hd // 2
        exps = -torch.arange(0, half, dtype=torch.float32) / half
        old = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
        new = layers.rope_inv_freq(hd, theta)
        assert torch.equal(old.view(torch.int32), new.view(torch.int32))


def test_autograd_function_runs_one_launch_each_way(monkeypatch):
    """``rope_fused.rope`` is one path under autograd and without it: the
    forward calls ``launch`` once, the backward once with ``backward`` and
    contiguous gradients, and the node saves only the positions and
    ``inv_freq``.  A CPU stand-in for ``launch`` (the rotation by the plain
    version, the sine negated for the backward) gives autograd's gradients
    through the plain version."""
    calls = []

    def stand_in(q, k, positions, inv_freq, *, backward=False):
        calls.append((backward, q.is_contiguous() and k.is_contiguous()))
        ang = positions[..., None].float() * inv_freq
        cos, sin = torch.cos(ang), torch.sin(ang)
        sin = -sin if backward else sin
        return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)

    monkeypatch.setattr(rope_fused, "launch", stand_in)
    cfg = _cfg()
    q, k = _qk((2, 5, 4, 16), 2, seed=6)
    pos = torch.arange(5, dtype=torch.int32)
    inv = layers.rope_inv_freq(16, cfg.rope_theta)
    with torch.no_grad():
        got = rope_fused.rope(q, k, pos, inv)
    assert calls == [(False, True)] and got[0].grad_fn is None
    gq = torch.randn((2, 4, 5, 16)).transpose(1, 2)
    gk = torch.randn(k.shape)
    leaves = [t.detach().requires_grad_(True) for t in (q, k)]
    out = rope_fused.rope(*leaves, pos, inv)
    saved = out[0].grad_fn.saved_tensors
    assert len(saved) == 2 and saved[0] is pos and saved[1] is inv
    torch.autograd.backward(out, (gq, gk))
    assert calls[1:] == [(False, True), (True, True)]
    plain = [t.detach().requires_grad_(True) for t in (q, k)]
    torch.autograd.backward(_plain(cfg, *plain, pos), (gq, gk))
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the RoPE kernel has no CPU mode")
    return torch.device("cuda")


def _ordered(t):
    """Each value's place on the line of its dtype's floats (ulp steps)."""
    if t.dtype == torch.float32:
        i, mask = t.view(torch.int32).to(torch.int64), 0x7FFFFFFF
    else:
        i, mask = t.view(torch.int16).to(torch.int64), 0x7FFF
    return torch.where(i < 0, -(i & mask), i)


def _diff(got, want, what):
    """The largest ulp distance over the pairs; prints how many differ."""
    worst, n_diff, n = 0, 0, 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        d = (_ordered(a) - _ordered(b)).abs()
        worst = max(worst, int(d.max()))
        n_diff += int((d > 0).sum())
        n += a.numel()
    print(f"{what}: {n_diff} of {n} outputs differ from the plain version, "
          f"at most {worst} ulp")
    return worst


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,s", [(_BF, s) for s in _CELL_LENGTHS]
                         + [(torch.float16, 512), (torch.float32, 512)],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_forward_matches_plain_on_card(cuda_device, dtype, s):
    """q [8, S, 32, 64] and k [8, S, 8, 64] (granite-3-2b's heads) at the
    benchmark cells' lengths in bf16, and in fp16 and float32 at 512: one
    launch, within one ulp of the plain version on the same card tensors
    (bit equality expected), the inputs unchanged."""
    cfg = configs.get_config("granite-3-2b")
    q, k = _qk((8, s, 32, 64), 8, dtype=dtype, device=cuda_device, seed=s)
    copies = (q.clone(), k.clone())
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)
    before = _counts()
    got = layers.rope_qk(cfg, q, k, pos)
    torch.cuda.synchronize()
    assert _counts() == {**before, "rope_fwd": before["rope_fwd"] + 1}
    assert torch.equal(q, copies[0]) and torch.equal(k, copies[1])
    assert _diff(got, _plain(cfg, q, k, pos), f"{dtype} S={s}") <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [_BF, torch.float32])
def test_decode_rows_at_their_own_positions_on_card(cuda_device, dtype):
    """Decode's per-row positions ``[B, 1]`` (a strided view of ``[B]``,
    and an expanded one, every row at one position), with head padding's
    odd head count and a head dim whose half is not a whole vector (the
    one-element path): within one ulp of the plain version."""
    for hd, hq, hkv in ((64, 32, 8), (128, 40, 8), (20, 5, 1)):
        cfg = _cfg(head_dim=hd, theta=500000.0)
        q, k = _qk((8, 1, hq, hd), hkv, dtype=dtype, device=cuda_device,
                   seed=hd)
        rows = torch.tensor([0, 1, 77, 511, 1024, 4031, 8191, 32767],
                            dtype=torch.int32, device=cuda_device)
        one = torch.full((), 4000, dtype=torch.int32,
                         device=cuda_device).expand(8)
        for pos in (rows[:, None], one[:, None]):
            got = layers.rope_qk(cfg, q, k, pos)
            assert _diff(got, _plain(cfg, q, k, pos),
                         f"decode {dtype} hd={hd}") <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [_BF, torch.float16, torch.float32])
def test_backward_matches_autograd_through_plain_on_card(cuda_device, dtype):
    """The gradients of q and k through the kernel (one ``rope_bwd``
    launch) against autograd through the plain version, within one ulp; a
    non-contiguous upstream gradient is taken."""
    cfg = configs.get_config("granite-3-2b")
    q, k = _qk((4, 512, 32, 64), 8, dtype=dtype, device=cuda_device, seed=9)
    pos = torch.arange(512, dtype=torch.int32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    gq = torch.randn((4, 32, 512, 64), generator=gen, device=cuda_device
                     ).to(dtype).transpose(1, 2)
    gk = torch.randn(k.shape, generator=gen, device=cuda_device).to(dtype)

    def grads(fn):
        qq, kk = (t.detach().requires_grad_(True) for t in (q, k))
        oq, ok = fn(cfg, qq, kk, pos)
        torch.autograd.backward((oq, ok), (gq, gk))
        return qq.grad, kk.grad

    before = _counts()
    got = grads(layers.rope_qk)
    torch.cuda.synchronize()
    assert _counts() == {**before, "rope_fwd": before["rope_fwd"] + 1,
                         "rope_bwd": before["rope_bwd"] + 1}
    assert _diff(got, grads(_plain), f"backward {dtype}") <= 1


def _small(dev, **kw):
    cfg = dataclasses.replace(configs.get_reduced("granite-3-2b"), **kw)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(4),
                        device=dev)
    tok = torch.randint(0, cfg.vocab_size, (2, 65), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
    return cfg, model, params, tok


@pytest.mark.gpu
def test_one_launch_an_attention_call_on_card(cuda_device):
    """A small RoPE model on the card: a prefill launches one ``rope_fwd``
    a layer, a decode step one a layer, a train step one ``rope_fwd`` and
    one ``rope_bwd`` a layer; nothing takes the plain path."""
    cfg, model, params, tok = _small(cuda_device, attn_impl="pallas")
    n = cfg.n_layers

    def delta(fn):
        before = _counts()
        fn()
        torch.cuda.synchronize()
        return {k: v - before[k] for k, v in _counts().items()}

    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tok[:, :64]},
                                      max_len=80)
        assert delta(lambda: model.prefill(params, {"tokens": tok[:, :64]},
                                           max_len=80)) == \
            {"rope_fwd": n, "rope_bwd": 0, "rope_plain": 0}
        assert delta(lambda: model.decode_step(
            params, logits.argmax(-1), cache, 64)) == \
            {"rope_fwd": n, "rope_bwd": 0, "rope_plain": 0}
    cfg, model, params, tok = _small(cuda_device)
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, opt)
    state = TrainState(params=params, opt=opt.init(params))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    assert delta(lambda: step(state, batch)) == \
        {"rope_fwd": n, "rope_bwd": n, "rope_plain": 0}


@pytest.mark.gpu
def test_nothing_inside_attn_rope_waits_for_the_card(cuda_device,
                                                     monkeypatch):
    """A prefill and a train step of a small RoPE model run with
    ``torch.cuda.set_sync_debug_mode("error")`` on inside every
    ``attn.rope`` span (spans are off, so the span itself is the only
    change): no error is raised there.  The old base, a float32 tensor
    copied to the card, raises under the same guard."""
    cfg, model, params, tok = _small(cuda_device)
    server = Model(dataclasses.replace(cfg, attn_impl="pallas"))
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, opt)
    state = TrainState(params=params, opt=opt.init(params))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    with torch.no_grad():  # builds and loads the libraries, fills caches
        server.prefill(params, {"tokens": tok[:, :64]})
    step(state, batch)
    torch.cuda.synchronize()
    span = trace.span
    guarded = []

    @contextlib.contextmanager
    def guard():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def spy(name):
        if name != "attn.rope":
            return span(name)
        guarded.append(name)
        return guard()

    monkeypatch.setattr(trace, "span", spy)
    with torch.no_grad():
        server.prefill(params, {"tokens": tok[:, :64]})
    step(state, batch)
    torch.cuda.synchronize()
    assert len(guarded) == 2 * cfg.n_layers
    exps = -torch.arange(0, 8, dtype=torch.float32, device=cuda_device) / 8
    with pytest.raises(RuntimeError), guard():
        torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                               device=cuda_device), exps)
    torch.cuda.synchronize()
    assert np.isfinite(float(step(state, batch)[1]["loss"]))
