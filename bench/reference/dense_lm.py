"""Plain reference of a dense decoder LM (Granite / Llama layout: RMSNorm,
rotary positions on split halves, grouped-query attention, SwiGLU, tied
or untied head) in float32 with TF32 off, and its AdamW training step.

The configuration is a Hugging Face ``config.json``-style dict.  The
weights are made here from a seed on the device, in one draw, in the tree
layout that both this reference and the program read (stacked over
layers).  Imports only PyTorch.

``mm`` selects the matmul: :func:`torch.matmul` for the reference, or
:func:`fp8_matmul`, the same operands rounded to float8 e4m3 with one
scale a tensor (forward and backward), for the lower-precision control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dims(cfg: dict) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "f": cfg["intermediate_size"],
            "layers": cfg["num_hidden_layers"], "h": h,
            "kv": cfg["num_key_value_heads"], "hd": d // h,
            "vocab": cfg["vocab_size"]}


def _leaf_shapes(cfg: dict) -> list:
    """(path, shape, std) of every drawn leaf, in draw order."""
    k = dims(cfg)
    d, f, n, h, kv, hd, v = (k["d"], k["f"], k["layers"], k["h"], k["kv"],
                             k["hd"], k["vocab"])
    out = [(("embed", "table"), (v, d), 1 / math.sqrt(d)),
           (("attn", "wq"), (n, d, h, hd), 1 / math.sqrt(d)),
           (("attn", "wk"), (n, d, kv, hd), 1 / math.sqrt(d)),
           (("attn", "wv"), (n, d, kv, hd), 1 / math.sqrt(d)),
           (("attn", "wo"), (n, h, hd, d), 1 / math.sqrt(h * hd)),
           (("mlp", "wi"), (n, d, f), 1 / math.sqrt(d)),
           (("mlp", "wg"), (n, d, f), 1 / math.sqrt(d)),
           (("mlp", "wo"), (n, f, d), 1 / math.sqrt(f))]
    if not cfg["tie_word_embeddings"]:
        out.append((("embed", "unembed"), (v, d), 1 / math.sqrt(d)))
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """Float32 weights from ``seed``: one normal draw on ``device`` cut
    into the leaves, each scaled by 1/sqrt(its fan-in); norm scales 1.  The
    tree: ``embed.table``, ``final_norm.scale`` and ``blocks.l0_dense``'s
    ``ln1``, ``attn`` (wq [L, d, h, hd], wk, wv [L, d, kv, hd], wo [L, h,
    hd, d]), ``ln2`` and ``mlp`` (wi, wg [L, d, f], wo [L, f, d])."""
    k = dims(cfg)
    shapes = _leaf_shapes(cfg)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    leaves, at = {}, 0
    for path, shape, std in shapes:
        size = math.prod(shape)
        leaves[path] = flat[at:at + size].view(shape).mul_(std)
        at += size
    n, d = k["layers"], k["d"]

    def ones(*shape):
        return torch.ones(shape, device=device)

    embed = {"table": leaves[("embed", "table")]}
    if ("embed", "unembed") in leaves:
        embed["unembed"] = leaves[("embed", "unembed")]
    block = {"ln1": {"scale": ones(n, d)},
             "attn": {w: leaves[("attn", w)] for w in ("wq", "wk", "wv",
                                                        "wo")},
             "ln2": {"scale": ones(n, d)},
             "mlp": {w: leaves[("mlp", w)] for w in ("wi", "wg", "wo")}}
    return {"embed": embed, "final_norm": {"scale": ones(d)},
            "blocks": {"l0_dense": block}}


def slices(tree, prefix: str = "") -> dict:
    """Every leaf of a params-shaped tree cut into its layers: name ->
    tensor (a stacked leaf gives one entry a layer)."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(slices(value, name))
        elif name.startswith("blocks."):
            for i, t in enumerate(value.unbind(0)):
                out[f"{name}[{i}]"] = t
        else:
            out[name] = value
    return out


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _q8(t: torch.Tensor) -> torch.Tensor:
    scale = 448.0 / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_q8(a), _q8(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        qg = _q8(g)
        ga = torch.matmul(qg, _q8(b).transpose(-1, -2))
        if b.dim() == 2 and a.dim() > 2:
            gb = _q8(a).reshape(-1, a.shape[-1]).t() @ qg.reshape(
                -1, g.shape[-1])
        else:
            gb = torch.matmul(_q8(a).transpose(-1, -2), qg)
        return ga, gb


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _FP8MatMul.apply(a, b)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """Rotate the halves of x [B, S, H, hd] by position."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def forward(params: dict, cfg: dict, tokens: torch.Tensor, *,
            mm=torch.matmul, last_only: bool = False) -> torch.Tensor:
    """Logits [B, S, V] (or [B, V] of the last position) in float32."""
    k = dims(cfg)
    h, kv, hd, d = k["h"], k["kv"], k["hd"], k["d"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    blk = params["blocks"]["l0_dense"]
    table = params["embed"]["table"]
    b, s = tokens.shape
    x = table[tokens]
    pos = torch.arange(s, device=tokens.device)
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=tokens.device).triu(1)
    # each stacked leaf cut once (its backward stacks the layers' gradients)
    layer = {g: {w: t.unbind(0) for w, t in blk[g].items()}
             for g in ("ln1", "attn", "ln2", "mlp")}
    for l in range(k["layers"]):
        at = {w: t[l] for w, t in layer["attn"].items()}
        y = rmsnorm(x, layer["ln1"]["scale"][l], eps)
        q = mm(y, at["wq"].reshape(d, h * hd)).view(b, s, h, hd)
        kk = mm(y, at["wk"].reshape(d, kv * hd)).view(b, s, kv, hd)
        vv = mm(y, at["wv"].reshape(d, kv * hd)).view(b, s, kv, hd)
        q, kk = rope(q, pos, theta), rope(kk, pos, theta)
        kk = kk.repeat_interleave(h // kv, dim=2)
        vv = vv.repeat_interleave(h // kv, dim=2)
        sc = mm(q.transpose(1, 2), kk.permute(0, 2, 3, 1)) / math.sqrt(hd)
        p = torch.softmax(sc.masked_fill(causal, float("-inf")), -1)
        o = mm(p, vv.transpose(1, 2)).transpose(1, 2).reshape(b, s, h * hd)
        x = x + mm(o, at["wo"].reshape(h * hd, d))
        mp = {w: t[l] for w, t in layer["mlp"].items()}
        y = rmsnorm(x, layer["ln2"]["scale"][l], eps)
        x = x + mm(F.silu(mm(y, mp["wg"])) * mm(y, mp["wi"]), mp["wo"])
    x = rmsnorm(x, params["final_norm"]["scale"], eps)
    if last_only:
        x = x[:, -1]
    head = table if cfg["tie_word_embeddings"] else params["embed"]["unembed"]
    return mm(x, head.t())


def loss(params, cfg, tokens, labels, *, mm=torch.matmul) -> torch.Tensor:
    """Mean next-token cross-entropy (labels already shifted)."""
    logits = forward(params, cfg, tokens, mm=mm)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


# ---------------------------------------------------------------------------
# AdamW (bias-corrected, decoupled decay, global-norm clipping)
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for key in tree:
            yield from _leaves(tree[key])
    else:
        yield tree


def train_steps(params: dict, cfg: dict, batches, hp: dict, *,
                mm=torch.matmul):
    """AdamW steps of the loss over ``batches`` (dicts of tokens and
    labels), updating ``params`` in place.  Returns each step's loss and
    the first step's clipped gradient (as the update gets it) by
    :func:`slices`."""
    leaves = list(_leaves(params))
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
    losses, first = [], None
    for step, batch in enumerate(batches, start=1):
        for p in leaves:
            p.requires_grad_(True)
        value = loss(params, cfg, batch["tokens"], batch["labels"], mm=mm)
        grads = torch.autograd.grad(value, leaves)
        losses.append(float(value.detach()))
        with torch.no_grad():
            for p in leaves:
                p.requires_grad_(False)
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            clip = min(1.0, hp["clip_norm"] / max(float(norm), 1e-9)) \
                if hp["clip_norm"] > 0 else 1.0
            if step == 1:
                first = {k: clip * float(t.norm()) for k, t in
                         slices(_like(params, list(grads))).items()}
            for p, g, mi, vi in zip(leaves, grads, m, v):
                g = g * clip
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = mi / (1 - b1 ** step)
                vhat = vi / (1 - b2 ** step)
                delta = mhat / (vhat.sqrt() + eps) + hp["weight_decay"] * p
                p.sub_(hp["lr"] * delta)
            del grads
    return losses, first


def _like(tree, values):
    it = iter(values)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        return next(it)

    return rebuild(tree)
