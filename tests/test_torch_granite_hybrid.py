"""Granite 4.0's hybrid layout (``configs/granite_4_0_h_small.py``) on the
port's normal path against the benchmark's plain float32 reference
(``bench/reference/granite_hybrid_lm.py``), on the CPU at ``REDUCED``: one
10-layer period ``MMMMMAMMMM`` at width 64, 8 of 16 experts held, top-4,
float32, the weights the reference draws from a seed.

Tolerances: ``TOL`` = 1e-4 of the logits' scale for the program against the
reference, and for the loss and each leaf's gradient against its own
scale: float32 sums in another order through ten layers (the SSD chunked
against the reference's token-by-token recurrence, the gate applied before
the expert's down projection), as ``test_torch_lm``'s bound against the
JAX package; measured at a few 1e-7 here.  Sums of one quantity in two
groupings (the expert shares, the reference's own chunked SSD) are held to
``EXACT`` = 1e-5 of their scale.  Tracing on and off must give the same
bits.
"""

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.drivers import granite_hybrid_prefill as driver  # noqa: E402
from bench.reference import granite_hybrid_lm as ref  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import granite_4_0_h_small as granite  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.config import PatternConfig  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402

TOL = 1e-4
EXACT = 1e-5
SEED = 2**31 + 17
B, S, PREFIX, STEPS = 2, 32, 24, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small ops: one intra-op thread a test process
    keeps them from spinning against the other test processes' threads
    (the suite runs several workers on shared cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_cfg(cfg) -> dict:
    """The reference's ``config.json``-style dict of a port config."""
    kinds = {"M": "mamba", "A": "attention"}
    reps = cfg.n_layers // len(cfg.layer_pattern)
    return {
        "name": cfg.name, "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "layer_types": [kinds[c] for c in cfg.layer_pattern] * reps,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "vocab_size": cfg.vocab_size,
        "mamba_n_heads": cfg.ssm_heads, "mamba_d_head": cfg.ssm_headdim,
        "mamba_expand": cfg.ssm_expand, "mamba_n_groups": 1,
        "mamba_d_state": cfg.ssm_state, "mamba_d_conv": cfg.ssm_conv,
        "mamba_chunk_size": cfg.ssm_chunk, "mamba_conv_bias": True,
        "mamba_proj_bias": False, "attention_bias": False,
        "hidden_act": "silu", "router_experts": cfg.n_experts,
        "num_local_experts": cfg.held, "experts_first": cfg.experts_first,
        "num_experts_per_tok": cfg.top_k,
        "intermediate_size": cfg.d_ff_expert,
        "shared_intermediate_size": cfg.d_ff_shared,
        "rms_norm_eps": cfg.norm_eps,
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "logits_scaling": cfg.logits_scaling,
        "attention_multiplier": cfg.attention_multiplier,
        "position_embedding_type": "nope", "tie_word_embeddings": True,
        "torch_dtype": cfg.dtype}


def _setup(impl="xla", **over):
    cfg = dataclasses.replace(granite.REDUCED, attn_impl=impl, **over)
    rc = ref_cfg(cfg)
    return cfg, rc, ref.make_params(rc, SEED, "cpu")


def _tokens(cfg, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_the_benchmark_config_maps_to_the_published_config():
    """The benchmark's file, its two cut keys set back to the published
    values, is ``CONFIG``; as it is run, 10 layers and experts 0-8 held."""
    import json

    body = json.loads((ROOT / "bench/configs/granite-4.0-h-small.json")
                      .read_text())
    whole = dict(body, **body["source_values"])
    cfg = driver.model_config(whole, {"attn_impl": "xla"})
    # the benchmark stacks every layer kept as one super-block
    assert cfg.layer_pattern == granite.CONFIG.layer_pattern * 4
    assert cfg == dataclasses.replace(granite.CONFIG, experts_held=72,
                                      layer_pattern=cfg.layer_pattern)
    assert cfg.held == granite.CONFIG.held == 72
    cut = driver.model_config(body, {"attn_impl": "pallas"})
    assert (cut.n_layers, cut.held, cut.experts_first, cut.n_experts) == \
        (10, 9, 0, 72)
    assert cut.layer_pattern == "MMMMMAMMMM"


def test_the_reduced_config_is_the_references():
    cfg = dataclasses.replace(granite.REDUCED, attn_impl="xla")
    got = driver.model_config(ref_cfg(cfg), {"attn_impl": "xla"})
    assert got == dataclasses.replace(cfg, attn_chunk=got.attn_chunk)


def test_the_init_tree_is_the_references():
    cfg, rc, rp = _setup()
    tp = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        return {k: tuple(v.shape) for k, v in ref.slices(tree).items()}

    assert shapes(tp) == shapes(rp)
    assert set(Model(cfg).param_specs()["blocks"]) == set(ref.layer_keys(rc))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_matches_the_reference(impl):
    cfg, rc, rp = _setup(impl)
    tok = _tokens(cfg)
    with torch.no_grad():
        got, aux = Model(cfg).forward(rp, {"tokens": tok})
        want = ref.forward(rp, rc, tok)
    assert _rel(got, want) <= TOL
    assert float(aux) == 0.0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_then_decode_matches_the_references_forward(impl):
    """A prefill of ``PREFIX`` tokens (three SSD chunks) and ``STEPS``
    decode steps through the one cache tree that holds the mamba states
    beside the attention layer's KV cache, against the reference's full
    forward at each position."""
    cfg, rc, rp = _setup(impl)
    tok = _tokens(cfg)
    model = Model(cfg)
    with torch.no_grad():
        want = ref.forward(rp, rc, tok)
        logits, cache = model.prefill(rp, {"tokens": tok[:, :PREFIX]},
                                      max_len=S)
        assert set(cache) == set(ref.layer_keys(rc))
        assert set(cache["l0_mamba"]) == {"state", "conv_x", "conv_b",
                                          "conv_c"}
        assert set(cache["l5_attn"]) == {"k", "v"}
        assert _rel(logits, want[:, PREFIX - 1]) <= TOL
        for i in range(STEPS):
            logits, cache = model.decode_step(rp, tok[:, PREFIX + i], cache,
                                              PREFIX + i)
            assert _rel(logits, want[:, PREFIX + i]) <= TOL, i


def test_loss_and_every_leafs_gradient_match_the_reference():
    cfg, rc, rp = _setup()
    tok = _tokens(cfg)
    labels = torch.roll(tok, -1, dims=1)
    stacked = list(_leaves(rp))
    for t in stacked:
        t.requires_grad_(True)
    got, _ = Model(cfg).loss(rp, {"tokens": tok, "labels": labels})
    g_got = torch.autograd.grad(got, stacked)
    want = ref.loss(rp, rc, tok, labels)
    g_want = torch.autograd.grad(want, stacked)
    assert abs(float(got.detach()) - float(want.detach())) <= \
        TOL * abs(float(want.detach()))
    names = list(ref.slices(rp))
    assert len(names) == len(stacked)
    for name, a, b in zip(names, g_got, g_want):
        assert float(b.abs().max()) > 0, name
        assert _rel(a, b) <= TOL, name


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def _moe_inputs(cfg, seed=5, t=24):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(1, t, cfg.d_model, generator=g)


def test_the_expert_shares_add_up_to_the_whole_layer():
    """Four chips of 4 experts each: the routed parts of every share, and
    the shared MLP that each chip computes alike counted once, add up to
    the uncut reference layer over all 16 experts."""
    whole, rc, rp = _setup(experts_held=16)
    k = ref.dims(rc)
    layer = ref.first(rp["blocks"]["l0_mamba"]["moe"])
    x = _moe_inputs(whole)
    with torch.no_grad():
        want = ref.moe(layer, x, k, torch.matmul)
        shared = ref.swiglu(x, layer["shared"]["wi"], layer["shared"]["wg"],
                            layer["shared"]["wo"], torch.matmul)
        parts = []
        for first in range(0, 16, 4):
            cfg = dataclasses.replace(whole, experts_held=4,
                                      experts_first=first)
            share = dict(layer, **{w: layer[w][first:first + 4]
                                   for w in ("wi", "wg", "wo")})
            parts.append(t_moe.moe_dropless(share, cfg, x) - shared)
    assert _rel(sum(parts) + shared, want) <= EXACT


def _biased(held):
    """A layer whose router sends every token to experts 1, 3, 4 and 6
    (their router columns biased along one direction of the input), with
    48 tokens that lie along it."""
    cfg, rc, rp = _setup(experts_held=held)
    layer = ref.first(rp["blocks"]["l0_mamba"]["moe"])
    direction = torch.zeros(cfg.d_model)
    direction[0] = 1.0
    x = _moe_inputs(cfg, t=48) + 10.0 * direction
    layer["router"][:, [1, 3, 4, 6]] += 50.0 * direction[:, None]
    return cfg, ref.dims(rc), layer, x


def test_a_router_that_sends_every_token_to_the_same_experts_drops_nothing():
    """Every token picks the same four held experts, so each of them gets
    all 48 tokens: the layer keeps all 192 choices, counts none dropped,
    and matches the reference.  The capacity path, given the same layer
    with all 16 experts held, drops choices."""
    cfg, k, layer, x = _biased(8)
    trace.drain()
    trace.enable(spans=False)
    try:
        with torch.no_grad():
            got = t_moe.moe_dropless(layer, cfg, x)
    finally:
        trace.disable()
    counts = trace.drain().counters
    assert counts["moe.kept"].tolist() == [0, 48, 0, 48, 48, 0, 48, 0]
    assert int(counts["moe.dropped"]) == 0
    with torch.no_grad():
        want = ref.moe(layer, x, k, torch.matmul)
    assert _rel(got, want) <= TOL
    cfg, k, layer, x = _biased(16)
    with torch.no_grad():
        want = ref.moe(layer, x, k, torch.matmul)
        dropless = t_moe.moe_dropless(layer, cfg, x)
        capacity = t_moe.moe_block(layer, dataclasses.replace(
            cfg, moe_dropless=False, layer_pattern=""), x)[0]
    assert _rel(dropless, want) <= TOL
    assert _rel(capacity, want) > 0.1


@pytest.mark.parametrize("chunk", [8, 5, 32])
def test_the_references_chunked_ssd_equals_its_step_recurrence(chunk):
    g = torch.Generator().manual_seed(7)
    bsz, s, heads, p, n = 2, 29, 3, 4, 5
    x = torch.randn(bsz, s, heads, p, generator=g, dtype=torch.float64)
    dt = torch.rand(bsz, s, heads, generator=g, dtype=torch.float64) * 0.5
    a = -torch.rand(heads, generator=g, dtype=torch.float64) * 8
    b, c = (torch.randn(bsz, s, n, generator=g, dtype=torch.float64)
            for _ in range(2))
    want, want_state = ref.ssd_steps(x, dt, a, b, c)
    got, got_state = ref.ssd_chunked(x, dt, a, b, c, chunk=chunk)
    assert _rel(got, want) <= EXACT
    assert _rel(got_state, want_state) <= EXACT


def test_tracing_on_and_off_gives_the_same_logits_and_the_layer_spans():
    cfg, rc, rp = _setup("pallas")
    tok = _tokens(cfg)
    model = Model(cfg)
    with torch.no_grad():
        off, _ = model.prefill(rp, {"tokens": tok})
        fwd_off, _ = model.forward(rp, {"tokens": tok})
        trace.drain()
        trace.enable()
        try:
            on, _ = model.prefill(rp, {"tokens": tok})
            fwd_on, _ = model.forward(rp, {"tokens": tok})
        finally:
            trace.disable()
    rec = trace.drain()
    assert torch.equal(on, off) and torch.equal(fwd_on, fwd_off)
    names = [s[0] for s in rec.spans]
    parent = {i: rec.spans[s[1]][0] if s[1] >= 0 else None
              for i, s in enumerate(rec.spans)}
    for child, want in (("ssm.proj", "lm.ssm"), ("ssm.conv", "lm.ssm"),
                        ("ssm.scan", "lm.ssm"), ("ssm.out", "lm.ssm"),
                        ("moe.route", "lm.moe"), ("moe.dispatch", "lm.moe"),
                        ("moe.experts", "lm.moe"), ("moe.combine", "lm.moe"),
                        ("moe.shared", "lm.moe"), ("lm.moe", "lm.ffn")):
        got = {parent[i] for i, n in enumerate(names) if n == child}
        assert got == {want}, child
    # a prefill and a forward: ten FFNs and nine mamba mixers each, the
    # prefill's under lm.prefill
    assert names.count("lm.moe") == 2 * cfg.n_layers
    assert names.count("lm.ssm") == 2 * 9
    assert {parent[i] for i, n in enumerate(names) if n == "lm.ssm"} == \
        {"lm.prefill", None}
    assert int(rec.counters["moe.dropped"]) == 0
    assert int(rec.counters["moe.kept"].sum()) > 0


def test_param_counts_against_a_hand_count():
    """``CONFIG`` whole: 32.2 B parameters, 8.8 B a token meets (the
    published 32B-A9B)."""
    d, di, n, hs = 4096, 8192, 128, 128
    mamba = d * (2 * di + 2 * n + hs) + 4 * (di + 2 * n) + (di + 2 * n) \
        + 3 * hs + di + di * d
    attn = d * 128 * (32 + 16) + 32 * 128 * d
    expert = 3 * d * 768
    other = d * 72 + 3 * d * 1536
    base = 100352 * d + d + 36 * mamba + 4 * attn + 40 * 2 * d
    total = base + 40 * (other + 72 * expert)
    active = base + 40 * (other + 10 * expert)
    assert granite.CONFIG.param_count() == total == 32_207_337_984
    assert granite.CONFIG.active_param_count() == active == 8_803_121_664
    assert round(total / 1e9, 1) == 32.2 and round(active / 1e9) == 9
    # nine of 72 held, ten layers: the experts at 9 x 10 / 72 a token
    cut = dataclasses.replace(granite.CONFIG, n_layers=10, experts_held=9)
    base10 = 100352 * d + d + 9 * mamba + attn + 10 * 2 * d
    assert cut.param_count() == base10 + 10 * (other + 9 * expert)
    assert cut.active_param_count() == base10 + 10 * (
        other + 10 * 9 * expert // 72)


def test_the_dropless_layout_may_prefill():
    """Unlike the capacity ``moe`` family, whose prefill can drop choices
    that decode keeps, the dropless layout prefills every whole SSD chunk
    of a prompt (all of a prompt shorter than one)."""
    m = Model(granite.CONFIG)
    assert [m.prefill_len(n) for n in (1, 200, 256, 300, 4096, 4100)] == \
        [1, 200, 256, 256, 4096, 4096]
    assert Model(t_configs.get_reduced("qwen2-moe-a2.7b")).prefill_len(
        100) == 0


def test_the_new_fields_are_off_in_every_registered_config():
    """Off, and not fields: the registered configs' fields stay the JAX
    package's (its parity tests compare them whole)."""
    fields = {f.name for f in dataclasses.fields(PatternConfig)} - {
        f.name for f in dataclasses.fields(t_configs.get_config(
            "tinyllama-1.1b"))}
    assert fields == {"layer_pattern", "embedding_multiplier",
                      "residual_multiplier", "logits_scaling",
                      "attention_multiplier", "nope", "ssm_conv_bias",
                      "moe_dropless", "experts_held", "experts_first"}
    for name in t_configs.list_archs():
        for cfg in (t_configs.get_config(name), t_configs.get_reduced(name)):
            assert cfg.layer_pattern == "" and not cfg.nope
            assert (cfg.embedding_multiplier, cfg.residual_multiplier,
                    cfg.logits_scaling, cfg.attention_multiplier) == \
                (1.0, 1.0, 1.0, 0.0)
            assert not cfg.ssm_conv_bias and not cfg.moe_dropless
            assert cfg.attn_scale == 1.0 / math.sqrt(cfg.head_dim)
            assert cfg.held == cfg.n_experts


@pytest.mark.parametrize("r", [0.22, 4.0])
def test_a_dense_layout_takes_the_residual_multiplier_and_nope(r):
    """A dense ``PatternConfig`` with ``residual_multiplier`` r gives the
    logits of the same model with every attention and MLP ``wo`` scaled by
    r (each sub-layer's output is linear in its ``wo``): in the forward, the
    prefill and a decode step.  Under ``nope`` no ``attn.rope`` opens."""
    base = dataclasses.asdict(dataclasses.replace(
        t_configs.get_reduced("granite-3-2b"), dtype="float32"))
    cfg = PatternConfig(**base, residual_multiplier=r, nope=True)
    plain = PatternConfig(**base, nope=True)
    params = Model(cfg).init(torch.Generator().manual_seed(5), device="cpu")
    scaled = {**params, "blocks": {
        name: {**lp, **{part: {**lp[part], "wo": lp[part]["wo"] * r}
                        for part in ("attn", "mlp")}}
        for name, lp in params["blocks"].items()}}
    tok = _tokens(cfg)

    def logits(model, p):
        fwd, _ = model.forward(p, {"tokens": tok})
        pre, cache = model.prefill(p, {"tokens": tok[:, :PREFIX]},
                                   max_len=S)
        dec, _ = model.decode_step(p, tok[:, PREFIX], cache, PREFIX)
        return fwd, pre, dec

    with torch.no_grad():
        want = logits(Model(plain), scaled)
        trace.drain()
        trace.enable()
        try:
            got = logits(Model(cfg), params)
        finally:
            trace.disable()
    assert "attn.rope" not in {s[0] for s in trace.drain().spans}
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_a_bad_layout_is_refused():
    with pytest.raises(ValueError):
        Model(dataclasses.replace(granite.REDUCED, layer_pattern="MMX"))
    with pytest.raises(ValueError):
        Model(dataclasses.replace(granite.REDUCED, moe_dropless=False))
    qwen = dataclasses.asdict(t_configs.get_reduced("qwen2-moe-a2.7b"))
    with pytest.raises(ValueError):
        Model(PatternConfig(**qwen, moe_dropless=True))
    assert Model(PatternConfig(**qwen)).prefill_len(100) == 0
    with pytest.raises(ValueError):
        dataclasses.replace(granite.REDUCED, experts_first=9)
