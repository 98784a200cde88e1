"""The port's MoE, SSM and encoder-decoder modules against the JAX package's.

Module by module, in float32 with the JAX package's params carried over as
numpy: ``moe_block`` (top-k routing, capacity drops, padded experts, expert
groups, ties), ``ssm_block`` and ``ssm_decode_step`` (the chunked dual
form and the recurrence), ``encode`` (sinusoids, non-causal attention), and
each family's super-block layout and decode-cache tree.  Outputs within
1e-5 of their scale (1e-4 through the encoder's two layers).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import encdec as t_encdec  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pair(arch, **over):
    over.setdefault("dtype", "float32")
    return (dataclasses.replace(j_configs.get_reduced(arch), **over),
            dataclasses.replace(t_configs.get_reduced(arch), **over))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


MOE_CASES = {
    "reduced": (dict(), 2, 16),               # qwen2-moe: 8 experts, 6 real
    "tight": (dict(capacity_factor=0.5), 2, 16),   # most choices dropped
    "groups": (dict(expert_groups=2), 4, 8),  # two dispatch groups
    "interleaved": (dict(moe_interleave=2, top_k=2, n_shared_experts=0),
                    3, 5),                    # no shared experts, top-2
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_matches_jax(case):
    over, b, s = MOE_CASES[case]
    jcfg, tcfg = _pair("qwen2-moe-a2.7b", **over)
    jp = j_moe.init_moe(jax.random.PRNGKey(2), jcfg)
    x = np.random.default_rng(2).normal(
        size=(b, s, jcfg.d_model)).astype(np.float32)
    jy, jaux = j_moe.moe_block(jp, jcfg, jnp.asarray(x))
    ty, taux = t_moe.moe_block(params_from_numpy(_np(jp), "cpu"), tcfg,
                               torch.from_numpy(x))
    assert _rel(ty.numpy(), jy) <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    if case == "tight":   # drops happened: some tokens get no expert at all
        t = b * s // min(jcfg.expert_groups, b)
        assert t_moe.capacity(tcfg, t) * tcfg.n_experts < t * tcfg.top_k


def test_moe_ties_break_by_lower_index_as_jax():
    """A zero router makes every real expert's probability equal: the port
    picks the lowest indices, as ``lax.top_k`` does, and every padded expert
    stays empty."""
    jcfg, tcfg = _pair("qwen2-moe-a2.7b", n_shared_experts=0)
    jp = j_moe.init_moe(jax.random.PRNGKey(4), jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    x = np.random.default_rng(4).normal(
        size=(2, 8, jcfg.d_model)).astype(np.float32)
    jy, _ = j_moe.moe_block(jp, jcfg, jnp.asarray(x))
    tp = params_from_numpy(_np(jp), "cpu")
    ty, _ = t_moe.moe_block(tp, tcfg, torch.from_numpy(x))
    assert _rel(ty.numpy(), jy) <= 1e-5
    # experts 0-3 alone: zero the others and nothing changes
    dead = dict(tp, wo=tp["wo"].clone())
    dead["wo"][tcfg.top_k:] = 0.0
    again, _ = t_moe.moe_block(dead, tcfg, torch.from_numpy(x))
    assert torch.equal(again, ty)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
@pytest.mark.parametrize("s", [8, 32, 5])
def test_ssm_block_and_decode_match_jax(arch, s):
    """The chunked dual form at one chunk, several chunks and a short
    sequence (one chunk of 5), its cache, then 3 recurrent steps."""
    jcfg, tcfg = _pair(arch)
    jp = j_ssm.init_ssm(jax.random.PRNGKey(6), jcfg)
    tp = params_from_numpy(_np(jp), "cpu")
    u = np.random.default_rng(6).normal(
        size=(2, s + 3, jcfg.d_model)).astype(np.float32)
    jy, jc = j_ssm.ssm_block(jp, jcfg, jnp.asarray(u[:, :s]),
                             return_cache=True)
    ty, tc = t_ssm.ssm_block(tp, tcfg, torch.from_numpy(u[:, :s]),
                             return_cache=True)
    assert _rel(ty.numpy(), jy) <= 1e-5
    for k in ("state", "conv_x", "conv_b", "conv_c"):
        assert _rel(tc[k].numpy(), jc[k]) <= 1e-5, k
    for t in range(s, s + 3):
        jo, jc = j_ssm.ssm_decode_step(jp, jcfg, jnp.asarray(u[:, t:t + 1]),
                                       jc)
        to, tc = t_ssm.ssm_decode_step(tp, tcfg, torch.from_numpy(
            u[:, t:t + 1]), tc)
        assert _rel(to.numpy(), jo) <= 1e-5, t
    assert _rel(tc["state"].numpy(), jc["state"]) <= 1e-5


@pytest.mark.parametrize("s", [1, 2, 3])
def test_ssm_short_prefill_continues_like_the_recurrence(s):
    """A prefill shorter than the conv window leaves a full history (zero
    rows first), so decoding on from it equals the recurrence from an empty
    cache token by token."""
    _, cfg = _pair("mamba2-780m")
    p = t_ssm.init_ssm(torch.Generator().manual_seed(8), cfg)
    u = torch.randn(2, s + 4, cfg.d_model, generator=torch.Generator()
                    .manual_seed(9))
    _, cache = t_ssm.ssm_block(p, cfg, u[:, :s], return_cache=True)
    assert cache["conv_x"].shape == (2, cfg.ssm_conv - 1, cfg.d_inner)
    ref = t_ssm.init_ssm_cache(cfg, 2, torch.float32)
    for t in range(s):
        t_ssm.ssm_decode_step(p, cfg, u[:, t:t + 1], ref)
    for t in range(s, s + 4):
        got, cache = t_ssm.ssm_decode_step(p, cfg, u[:, t:t + 1], cache)
        want, ref = t_ssm.ssm_decode_step(p, cfg, u[:, t:t + 1], ref)
        assert _rel(got.numpy(), want.numpy()) <= 1e-5
    with pytest.raises(ValueError, match="ssm_chunk"):  # 12 > chunk 8
        t_ssm.ssm_block(p, cfg, torch.zeros(1, 12, cfg.d_model))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_encode_matches_jax(impl):
    """The encoder stack (sinusoids, non-causal attention without RoPE: B9's
    plain version with ``pallas``) and the sinusoid table."""
    jcfg, tcfg = _pair("whisper-large-v3", attn_impl=impl)
    jp = JModel(jcfg).init(jax.random.PRNGKey(1))
    frames = np.random.default_rng(1).normal(
        size=(2, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    want = j_encdec.encode(jp, jcfg, jnp.asarray(frames))
    got = t_encdec.encode(params_from_numpy(_np(jp), "cpu"), tcfg,
                          torch.from_numpy(frames))
    assert _rel(got.numpy(), want) <= 1e-4
    np.testing.assert_array_equal(t_encdec.sinusoids(1500, 1280),
                                  j_encdec.sinusoids(1500, 1280))


@pytest.mark.parametrize("arch", sorted(t_configs.list_archs()))
def test_layout_and_cache_tree_match_jax(arch):
    """Every registry config's super-block layout (full and reduced), and
    the reduced model's decode-cache tree: keys, shapes and dtypes (the
    hybrid's one cache per shared-attention invocation, the encdec's self
    and cross caches, float32 SSM states)."""
    for get in ("get_config", "get_reduced"):
        jcfg = getattr(j_configs, get)(arch)
        tcfg = getattr(t_configs, get)(arch)
        if jcfg.family != "encdec":
            assert t_lm.superblock_layout(tcfg) == \
                j_lm.superblock_layout(jcfg)
    jcfg, tcfg = _pair(arch, dtype="bfloat16")
    want = jax.eval_shape(lambda: JModel(jcfg).init_cache(3, 16))
    got = Model(tcfg).init_cache(3, 16, device="cpu")

    def same(w, g):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                same(w[k], g[k])
        else:
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).split(".")[-1] == str(w.dtype)

    same(want, got)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-780m",
                                  "zamba2-1.2b", "whisper-large-v3"])
def test_interop_round_trips_the_family_trees(arch):
    """``params_from_numpy``/``params_to_numpy`` carry the JAX package's tree
    (stacked super-blocks, MoE routers and experts, SSM layers, the hybrid's
    ``shared_attn``, the encoder and decoder stacks) and the port's own
    ``Model.init`` tree across bit for bit."""
    from repro_torch.interop import params_to_numpy

    jcfg, tcfg = _pair(arch)
    want = _np(JModel(jcfg).init(jax.random.PRNGKey(5)))
    got = params_to_numpy(params_from_numpy(want, "cpu"))
    own = Model(tcfg).init(torch.Generator().manual_seed(5), device="cpu")
    back = params_from_numpy(params_to_numpy(own), "cpu")

    def same(w, g):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                same(w[k], g[k])
        elif isinstance(w, torch.Tensor):
            assert torch.equal(w, g)
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    same(want, got)
    same(own, back)
    if tcfg.family == "hybrid":
        assert "shared_attn" in got and got["shared_attn"]["attn"]["wq"].ndim == 3
