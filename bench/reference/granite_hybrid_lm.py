"""Plain reference of a Granite 4.0 hybrid decoder (``granitemoehybrid``:
Mamba-2 and attention layers, each followed by a mixture of experts and a
shared MLP) in float32 with TF32 off, written from the Hugging Face
description of ``GraniteMoeHybridForCausalLM``:

* the input embedding times ``embedding_multiplier``;
* each layer: ``x + mixer(rmsnorm(x)) * residual_multiplier``, then
  ``x + (moe(rmsnorm(x)) + shared_mlp(rmsnorm(x))) * residual_multiplier``;
  the mixer is the layer's ``layer_types`` entry;
* Mamba-2 (one group): ``z``, ``xBC`` and ``dt`` projected from the input,
  a depthwise causal conv of window ``mamba_d_conv`` with a bias on
  ``xBC`` and SiLU, ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``,
  the SSD recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
  ``y_t = C_t h_t + D x_t`` per head, then ``rmsnorm(y * silu(z))`` and the
  output projection;
* attention: grouped-query, no position embedding (``"nope"``), causal,
  scores times ``attention_multiplier``;
* experts: router logits over all ``router_experts``, the top
  ``num_experts_per_tok`` of them, a softmax over those logits, each chosen
  expert's SwiGLU output times its gate.  Only the experts this chip holds
  (``num_local_experts`` of them from ``experts_first``) are computed: the
  partial sum that one chip of an expert-parallel group gives;
* the head tied to the embedding, the logits over ``logits_scaling``.

The configuration is a Hugging Face ``config.json``-style dict with the
held experts' keys.  The weights are made here from a seed, in one normal
draw, in the tree layout that both this reference and the program read;
the Mamba-2 constants (``A_log``, ``dt_bias``, ``D``) are drawn as Mamba-2
initialises them.  The SSD runs step by step (:func:`ssd_steps`) or in its
chunked closed form (:func:`ssd_chunked`, the same sums regrouped a chunk at
a time), attention in blocks of queries, so that 32,768 tokens fit.
Imports only PyTorch and the fp8 matmul of :mod:`dense_lm`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.dense_lm import fp8_matmul, slices  # noqa: F401

KINDS = {"mamba": "mamba", "attention": "attn"}


def dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    heads, hp = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    if heads * hp != cfg["mamba_expand"] * d:
        raise ValueError("mamba_n_heads x mamba_d_head must be "
                         "mamba_expand x hidden_size")
    if cfg["mamba_n_groups"] != 1:
        raise ValueError("one B/C group only")
    types = cfg["layer_types"][: cfg["num_hidden_layers"]]
    return {"d": d, "layers": cfg["num_hidden_layers"], "types": types,
            "h": h, "kv": cfg["num_key_value_heads"], "hd": d // h,
            "vocab": cfg["vocab_size"], "di": heads * hp, "heads": heads,
            "hp": hp, "n": cfg["mamba_d_state"], "k": cfg["mamba_d_conv"],
            "e": cfg["router_experts"], "held": cfg["num_local_experts"],
            "first": cfg["experts_first"], "top": cfg["num_experts_per_tok"],
            "fe": cfg["intermediate_size"],
            "fs": cfg["shared_intermediate_size"]}


def layer_keys(cfg: dict) -> list:
    """Each layer's key in ``params["blocks"]``: ``l<i>_mamba`` or
    ``l<i>_attn``, one super-block of all the layers kept."""
    return [f"l{i}_{KINDS[t]}" for i, t in enumerate(dims(cfg)["types"])]


def _leaf_shapes(cfg: dict) -> list:
    """(path, shape, std) of every normal leaf, in draw order."""
    k = dims(cfg)
    d, h, kv, hd, di, n, heads = (k["d"], k["h"], k["kv"], k["hd"], k["di"],
                                  k["n"], k["heads"])
    sc = 1 / math.sqrt(k["k"])
    out = [(("embed", "table"), (k["vocab"], d), 1 / math.sqrt(d))]
    for key in layer_keys(cfg):
        if key.endswith("_mamba"):
            for w, shape, std in (
                    ("w_z", (d, di), d), ("w_x", (d, di), d),
                    ("w_b", (d, n), d), ("w_c", (d, n), d),
                    ("w_dt", (d, heads), d), ("w_out", (di, d), di)):
                out.append(((key, "ssm", w), (1,) + shape, 1 / math.sqrt(std)))
            for w, width in (("conv_x", di), ("conv_b", n), ("conv_c", n)):
                out.append(((key, "ssm", w), (1, k["k"], width), sc))
                out.append(((key, "ssm", w + "_bias"), (1, width), sc))
        else:
            for w, shape, std in (
                    ("wq", (d, h, hd), d), ("wk", (d, kv, hd), d),
                    ("wv", (d, kv, hd), d), ("wo", (h, hd, d), h * hd)):
                out.append(((key, "attn", w), (1,) + shape,
                            1 / math.sqrt(std)))
        held, fe, fs = k["held"], k["fe"], k["fs"]
        for w, shape, std in (
                ("router", (d, k["e"]), d), ("wi", (held, d, fe), d),
                ("wg", (held, d, fe), d), ("wo", (held, fe, d), fe)):
            out.append(((key, "moe", w), (1,) + shape, 1 / math.sqrt(std)))
        for w, shape, std in (("wi", (d, fs), d), ("wg", (d, fs), d),
                              ("wo", (fs, d), fs)):
            out.append(((key, "moe", "shared", w), (1,) + shape,
                        1 / math.sqrt(std)))
    return out


def _put(tree: dict, path: tuple, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def make_params(cfg: dict, seed: int, device) -> dict:
    """Float32 weights from ``seed``: one normal draw on ``device`` cut into
    the leaves, each scaled by 1/sqrt(its fan-in) (a conv's window and bias
    by 1/sqrt(window)); then, per mamba layer, ``a_log`` = log U[1, 16),
    ``dt_bias`` the inverse softplus of a log-uniform dt in [1e-3, 1e-1),
    ``d_skip`` 1 and norm scales 1.  The tree: ``embed.table``,
    ``final_norm.scale`` and ``blocks.<key>`` a layer (:func:`layer_keys`),
    each leaf stacked over one super-block: ``ln1``, ``ssm`` or ``attn``,
    ``ln2`` and ``moe`` (``router`` [d, router_experts], the held experts'
    ``wi``, ``wg`` [held, d, f], ``wo`` [held, f, d] and ``shared``)."""
    k = dims(cfg)
    shapes = _leaf_shapes(cfg)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    params: dict = {}
    at = 0
    for path, shape, std in shapes:
        size = math.prod(shape)
        _put(params, path, flat[at:at + size].view(shape).mul_(std))
        at += size
    blocks = {key: params.pop(key) for key in layer_keys(cfg)}
    d = k["d"]

    def ones(*shape):
        return torch.ones(shape, device=device)

    for key, block in blocks.items():
        block["ln1"] = {"scale": ones(1, d)}
        block["ln2"] = {"scale": ones(1, d)}
        if key.endswith("_mamba"):
            u = torch.rand(2, 1, k["heads"], generator=gen, device=device)
            dt = torch.exp(math.log(1e-3) + u[1] * math.log(100.0))
            block["ssm"].update(
                a_log=torch.log(1 + 15 * u[0]),
                dt_bias=dt + torch.log(-torch.expm1(-dt)),
                d_skip=ones(1, k["heads"]), norm=ones(1, k["di"]))
    return {"embed": params["embed"], "final_norm": {"scale": ones(d)},
            "blocks": blocks}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def ssd_steps(x, dt, a, b, c):
    """The SSD recurrence token by token.  x [B, S, H, P], dt [B, S, H],
    a [H], b, c [B, S, N] -> (y [B, S, H, P] without D's skip, the state
    after the last token [B, H, N, P])."""
    bsz, s, heads, p = x.shape
    state = x.new_zeros(bsz, heads, b.shape[-1], p)
    ys = []
    for t in range(s):
        state = (torch.exp(dt[:, t] * a)[..., None, None] * state
                 + dt[:, t, :, None, None] * b[:, t, None, :, None]
                 * x[:, t, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t], state))
    return torch.stack(ys, dim=1), state


def ssd_chunked(x, dt, a, b, c, chunk: int = 256):
    """The same recurrence a chunk at a time: within a chunk of length Q,
    ``y_i = sum_{j<=i} (C_i . B_j) exp(sum_{j<l<=i} dt_l a) dt_j x_j`` plus
    the carried state decayed to ``i`` and read by ``C_i``; the state then
    moves on by the chunk's decay.  Shapes as :func:`ssd_steps`."""
    bsz, s, heads, p = x.shape
    state = x.new_zeros(bsz, heads, b.shape[-1], p)
    ys = []
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        q = hi - lo
        xc, bc, cc = x[:, lo:hi], b[:, lo:hi], c[:, lo:hi]
        la = torch.cumsum(dt[:, lo:hi] * a, dim=1)              # [B, Q, H]
        later = torch.ones(q, q, dtype=torch.bool, device=x.device).triu(1)
        decay = torch.exp((la[:, :, None] - la[:, None]).masked_fill(
            later[None, :, :, None], float("-inf")))           # [B, Qi, Qj, H]
        cb = torch.einsum("bin,bjn->bij", cc, bc)
        w = cb[..., None] * decay * dt[:, lo:hi][:, None]        # [B, Qi, Qj, H]
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        y = y + torch.exp(la)[..., None] * torch.einsum(
            "bin,bhnp->bihp", cc, state)
        to_end = torch.exp(la[:, -1:] - la) * dt[:, lo:hi]       # [B, Q, H]
        state = (torch.exp(la[:, -1])[..., None, None] * state
                 + torch.einsum("bjn,bjh,bjhp->bhnp", bc, to_end, xc))
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _conv(seq, w, bias):
    """Depthwise causal conv (window K, the last tap on the current token)
    with a bias, then SiLU.  seq [B, S, C], w [K, C], bias [C]."""
    k = w.shape[0]
    pad = F.pad(seq, (0, 0, k - 1, 0))
    out = bias + sum(pad[:, i:i + seq.shape[1]] * w[i] for i in range(k))
    return F.silu(out)


def mamba(p: dict, x, k: dict, eps: float, mm, chunked: bool,
          cache: dict | None = None):
    """The Mamba-2 mixer; ``cache`` (a dict) is given the prefill's
    state: ``state`` the SSD's after the last token, ``conv_x``,
    ``conv_b`` and ``conv_c`` the last ``mamba_d_conv`` - 1 rows of the
    conv's inputs (S >= that)."""
    bsz, s, _ = x.shape
    z = mm(x, p["w_z"])
    pre = {w: mm(x, p["w_" + w[-1]]) for w in ("conv_x", "conv_b", "conv_c")}
    xs, b, c = (_conv(pre[w], p[w], p[w + "_bias"]) for w in pre)
    dt = F.softplus(mm(x, p["w_dt"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = xs.view(bsz, s, k["heads"], k["hp"])
    y, state = (ssd_chunked if chunked else ssd_steps)(xh, dt, a, b, c)
    if cache is not None:
        cache["state"] = state
        cache.update({w: t[:, s - (k["k"] - 1):] for w, t in pre.items()})
    y = y + p["d_skip"][:, None] * xh
    y = y.reshape(bsz, s, k["di"]) * F.silu(z)
    return mm(rmsnorm(y, p["norm"], eps), p["w_out"])


def attention(p: dict, x, k: dict, scale: float, mm, block: int = 512,
              cache: dict | None = None):
    """Causal GQA without positions, the queries in blocks of ``block``;
    ``cache`` (a dict) is given the keys and values [B, S, KV, hd]."""
    bsz, s, d = x.shape
    h, kv, hd = k["h"], k["kv"], k["hd"]
    q = mm(x, p["wq"].reshape(d, h * hd)).view(bsz, s, h, hd).transpose(1, 2)
    kk = mm(x, p["wk"].reshape(d, kv * hd)).view(bsz, s, kv, hd)
    vv = mm(x, p["wv"].reshape(d, kv * hd)).view(bsz, s, kv, hd)
    if cache is not None:
        cache.update(k=kk, v=vv)
    kk = kk.repeat_interleave(h // kv, dim=2).permute(0, 2, 3, 1)
    vv = vv.repeat_interleave(h // kv, dim=2).transpose(1, 2)
    outs = []
    for lo in range(0, s, block):
        hi = min(lo + block, s)
        sc = mm(q[:, :, lo:hi], kk[..., :hi]) * scale
        mask = (torch.arange(hi, device=x.device)[None, :]
                > torch.arange(lo, hi, device=x.device)[:, None])
        prob = torch.softmax(sc.masked_fill(mask, float("-inf")), -1)
        outs.append(mm(prob, vv[:, :, :hi]))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(bsz, s, h * hd)
    return mm(o, p["wo"].reshape(h * hd, d))


def swiglu(x, wi, wg, wo, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wi), wo)


def moe(p: dict, x, k: dict, mm):
    """The held experts' part of the routed sum plus the shared MLP."""
    bsz, s, d = x.shape
    xf = x.reshape(bsz * s, d)
    logits = mm(xf, p["router"])
    top, idx = torch.topk(logits, k["top"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(xf)
    for e in range(k["held"]):
        tok, slot = torch.nonzero(idx == k["first"] + e, as_tuple=True)
        if len(tok):
            out = swiglu(xf[tok], p["wi"][e], p["wg"][e], p["wo"][e], mm)
            y = y.index_add(0, tok, out * gates[tok, slot, None])
    sh = p["shared"]
    return y.view(bsz, s, d) + swiglu(x, sh["wi"], sh["wg"], sh["wo"], mm)


def first(tree):
    """A layer's tree with its one super-block taken out of every leaf."""
    if isinstance(tree, dict):
        return {k: first(v) for k, v in tree.items()}
    return tree[0]


def forward(params: dict, cfg: dict, tokens: torch.Tensor, *,
            mm=torch.matmul, last_only: bool = False,
            chunked: bool = False, cache: dict | None = None) -> torch.Tensor:
    """Logits [B, S, V] (or [B, V] of the last position) in float32; the SSD
    step by step, or in its chunked closed form with ``chunked``.  With
    ``cache`` (a dict), each layer's key (:func:`layer_keys`) is given the
    prefill's state, as a decode step would read it: :func:`mamba`'s and
    :func:`attention`'s."""
    k = dims(cfg)
    eps, res = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    table = params["embed"]["table"]
    x = table[tokens] * cfg["embedding_multiplier"]
    for key in layer_keys(cfg):
        one = first(params["blocks"][key])
        h = rmsnorm(x, one["ln1"]["scale"], eps)
        mine = None if cache is None else cache.setdefault(key, {})
        if key.endswith("_mamba"):
            h = mamba(one["ssm"], h, k, eps, mm, chunked, cache=mine)
        else:
            h = attention(one["attn"], h, k, cfg["attention_multiplier"], mm,
                          cache=mine)
        x = x + h * res
        h = rmsnorm(x, one["ln2"]["scale"], eps)
        x = x + moe(one["moe"], h, k, mm) * res
    x = rmsnorm(x, params["final_norm"]["scale"], eps)
    if last_only:
        x = x[:, -1]
    return mm(x, table.t()) / cfg["logits_scaling"]


def loss(params, cfg, tokens, labels, *, mm=torch.matmul) -> torch.Tensor:
    """Mean next-token cross-entropy (labels already shifted)."""
    logits = forward(params, cfg, tokens, mm=mm)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())
