"""Shared transformer layers: norms, embeddings, RoPE, MLP variants.

The JAX package's ``models/layers.py`` on torch.  Parameters are plain
dicts of tensors with the JAX package's keys and shapes; the cast points
are the JAX package's: RMSNorm and RoPE compute in float32 and cast back,
matmuls run in the activation dtype against weights cast to it per call.
Every ``init_*`` has a ``spec_*`` returning the same tree with a tuple of
logical axis names a leaf, one name a tensor dim (the JAX package's, which
``launch/specs.py`` resolves into placements).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import rope_fused
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import (constrain, local_call,
                                           replicated, whole)
from repro_torch.runtime import trace


def truncated_normal(generator: torch.Generator, shape,
                     scale: float) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2] (not
    renormalized, as ``jax.random.truncated_normal``), drawn from
    ``generator`` on its device."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device=None, *, stack: tuple = ()) -> dict:
    return {"scale": torch.ones(stack + (d,), dtype=torch.float32,
                                device=device)}


def spec_rmsnorm() -> dict:
    return {"scale": ("embed",)}


def stack_spec(tree, name: str = "layers"):
    """``tree`` with the stacked axis ``name`` prepended to every leaf."""
    if isinstance(tree, dict):
        return {k: stack_spec(v, name) for k, v in tree.items()}
    return (name,) + tree


def rmsnorm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    with trace.span("lm.norm"):
        dt = x.dtype
        x = x.float()
        var = torch.mean(x * x, dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + eps)
        return (x * params["scale"]).to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(generator: torch.Generator, cfg: ModelConfig) -> dict:
    scale = 1.0 / math.sqrt(cfg.d_model)
    shape = (cfg.vocab_size, cfg.d_model)
    p = {"table": truncated_normal(generator, shape, scale)}
    if not cfg.tie_embeddings:
        p["unembed"] = truncated_normal(generator, shape, scale)
    return p


def spec_embed(cfg: ModelConfig) -> dict:
    p = {"table": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        p["unembed"] = ("vocab", "embed")
    return p


def embed_tokens(params: dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    table = params["table"]
    if hasattr(tokens, "placements") or hasattr(table, "placements"):
        # each rank looks its rows up in the whole table (DTensor's own
        # lookup fails on batch rows split over two mesh dims)
        mesh = (table if hasattr(table, "placements") else tokens).device_mesh
        table = whole(mesh, table)
        tokens = replicated(mesh, tokens)
        x = local_call(lambda t, i: t[i], (table, tokens), tokens.placements)
    else:
        x = table[tokens]
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x.to(cfg.activation_dtype())


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    with trace.span("lm.unembed"):
        table = params["table"] if cfg.tie_embeddings else params["unembed"]
        logits = torch.matmul(x, table.to(x.dtype).t())
        if cfg.logits_scaling != 1.0:
            logits = logits / cfg.logits_scaling
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        if cfg.vocab_real and cfg.vocab_real < cfg.vocab_size:
            pad = (torch.arange(cfg.vocab_size, device=x.device)
                   >= cfg.vocab_real)
            logits = logits.masked_fill(pad, -1e30)
        return logits


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """The inverse frequencies ``theta ** (-2i / head_dim)``, float32
    ``[head_dim / 2]``.  The base is a Python float, so it reaches the card
    as a kernel argument: no copy from the host, no wait."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(float(theta), exps)


def rope_frequencies(cfg: ModelConfig, positions: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim/2] for integer positions."""
    freqs = rope_inv_freq(cfg.head_dim, cfg.rope_theta, positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, head_dim/2].
    Computed in float32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_INV_FREQ: dict = {}  # (device, head_dim, theta) -> rope_inv_freq on the card


def rope_qk(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
            positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, Hq, hd] and k [B, S, Hkv, hd] rotated by ``positions``
    ([S], or [B, S] as decode's [B, 1]).  Plain CUDA tensors take the
    kernel A2 (``kernels/rope_fused.py``: one launch for both, the angles
    made on the card from ``inv_freq``, built once a device and kept);
    DTensors and CPU tensors take :func:`rope_frequencies` and
    :func:`apply_rope`, counted in ``rope_fused.PLAIN``."""
    if not rope_fused.takes(q, k, positions):
        rope_fused.PLAIN["rope_plain"] += 1
        cos, sin = rope_frequencies(cfg, positions)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    key = (q.device, cfg.head_dim, float(cfg.rope_theta))
    inv_freq = _INV_FREQ.get(key)
    if inv_freq is None:
        with torch.inference_mode(False), torch.no_grad():
            inv_freq = _INV_FREQ[key] = rope_inv_freq(*key[1:], q.device)
    return rope_fused.rope(q, k, positions, inv_freq)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU) — digital matmuls or the paper's analog processor
# ---------------------------------------------------------------------------

def _analog_layers(cfg: ModelConfig, d: int, f: int) -> dict:
    """The MLP's three projections as tiled RF analog processors.

    The JAX package's ``rfnn_backend="pallas"`` is the port's
    ``backend="kernel"``: each projection's whole (To x Ti) tile grid is one
    launch of the deep-grid kernel B6 on the card (``ops.tiled_apply``).
    """
    from repro_torch.core.analog_linear import TiledAnalogLinear

    backend = {"pallas": "kernel", "reference": "reference"}[cfg.rfnn_backend]

    def mk(i, o):
        return TiledAnalogLinear(in_dim=i, out_dim=o, tile_size=cfg.rfnn_tile,
                                 quantize=cfg.rfnn_quantize, output="real",
                                 backend=backend)

    return {"wi": mk(d, f), "wg": mk(d, f), "wo": mk(f, d)}


def _gated(cfg: ModelConfig) -> bool:
    return cfg.mlp_variant in ("swiglu", "geglu")


def _act(cfg: ModelConfig):
    if cfg.mlp_variant == "swiglu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")  # jax.nn.gelu's default


def init_mlp(generator: torch.Generator, cfg: ModelConfig, *,
             stack: tuple = ()) -> dict:
    """MLP params, each leaf with the leading ``stack`` axes (the LM's
    stacked super-blocks).  The analog projections draw their phases from a
    CPU generator seeded from ``generator``."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.linear_impl == "rfnn":
        from repro_torch.core.analog_linear import _stack_trees

        layers = _analog_layers(cfg, d, f)
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device))
        host = torch.Generator().manual_seed(seed)
        names = ["wi", "wo"] + (["wg"] if _gated(cfg) else [])
        count = math.prod(stack)
        return {name: _stack_trees(
            [layers[name].init(host, device=generator.device)
             for _ in range(count)], stack) for name in names}
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"wi": truncated_normal(generator, stack + (d, f), s_in),
         "wo": truncated_normal(generator, stack + (f, d), s_out)}
    if _gated(cfg):
        p["wg"] = truncated_normal(generator, stack + (d, f), s_in)
    return p


def _replicated_like(tree):
    if isinstance(tree, dict):
        return {k: _replicated_like(v) for k, v in tree.items()}
    return (None,) * tree.dim()


def spec_mlp(cfg: ModelConfig | None = None) -> dict:
    """The MLP's specs; the analog projections' tiles all replicated (one
    unstacked layer's tree, drawn on the CPU for its ranks)."""
    if cfg is not None and cfg.linear_impl == "rfnn":
        return _replicated_like(init_mlp(
            torch.Generator().manual_seed(0), cfg))
    p = {"wi": ("embed", "ffn"), "wo": ("ffn", "embed")}
    if cfg is None or _gated(cfg):
        p["wg"] = ("embed", "ffn")
    return p


def _analog_mlp(params: dict, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    layers = _analog_layers(cfg, cfg.d_model, cfg.d_ff)
    xf = x.float()
    h = layers["wi"].apply(params["wi"], xf)
    if _gated(cfg):
        h = h * _act(cfg)(layers["wg"].apply(params["wg"], xf))
    else:
        h = F.gelu(h, approximate="tanh")
    return layers["wo"].apply(params["wo"], h).to(x.dtype)


def mlp(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.linear_impl == "rfnn":
        # the deep-grid kernels take device pointers: under a mesh each
        # rank runs them on its rows (features whole), the tiles replicated
        x = constrain(x, "batch", "seq", None) if x.dim() == 3 else x
        return local_call(lambda p, t: _analog_mlp(p, cfg, t), (params, x),
                          getattr(x, "placements", None))
    h = torch.matmul(x, params["wi"].to(dt))
    if _gated(cfg):
        g = torch.matmul(x, params["wg"].to(dt))
        h = h * _act(cfg)(g)
    else:  # plain gelu (whisper)
        h = F.gelu(h, approximate="tanh")
    if h.dim() == 3:
        h = constrain(h, "batch", "seq", "ffn")
    return torch.matmul(h, params["wo"].to(dt))
