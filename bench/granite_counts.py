"""The work of a Granite 4.0 hybrid prefill (``bench/configs/
granite-4.0-h-small.json``), counted from the model's equations at the
cell's shapes so that a count reads the same work whatever implements it:
the model flops of a batch, and the bounds of the SSD scan and of B9 (the
flash attention kernel).  The peaks are ``roofline.py``'s.
"""

from __future__ import annotations

from bench import roofline

# the SSD's chunk length in the dual form that the scan's bound counts
SSD_CHUNK = 256


def _sizes(cfg: dict) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    types = cfg["layer_types"][: cfg["num_hidden_layers"]]
    return {"d": d, "h": h, "kv": cfg["num_key_value_heads"], "hd": d // h,
            "di": cfg["mamba_n_heads"] * cfg["mamba_d_head"],
            "n": cfg["mamba_d_state"], "heads": cfg["mamba_n_heads"],
            "p": cfg["mamba_d_head"], "mamba": types.count("mamba"),
            "attn": types.count("attention"), "layers": len(types)}


def matmul_params(cfg: dict) -> float:
    """Weights a token meets in matmuls, the head left out: each mamba
    layer's z, x, B, C, dt and output projections, each attention layer's
    q, k, v, o, every layer's router and shared MLP, and the held experts
    at their expected share of a token's choices, ``top_k x held /
    router_experts`` experts a layer."""
    k = _sizes(cfg)
    d, di = k["d"], k["di"]
    mamba = d * (2 * di + 2 * k["n"] + k["heads"]) + di * d
    attn = d * k["hd"] * (k["h"] + 2 * k["kv"]) + k["h"] * k["hd"] * d
    router = d * cfg["router_experts"]
    shared = 3 * d * cfg["shared_intermediate_size"]
    share = (cfg["num_experts_per_tok"] * cfg["num_local_experts"]
             / cfg["router_experts"])
    experts = share * 3 * d * cfg["intermediate_size"]
    return (k["mamba"] * mamba + k["attn"] * attn
            + k["layers"] * (router + shared + experts))


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model flops of prefilling ``batch`` prompts of ``seq`` tokens with
    last-position logits: 2 per matmul weight and token, causal attention
    (QK^T and PV over half the score block), the SSD's 4 N P H a token and
    mamba layer (the state's update and its read), the head on one token a
    prompt."""
    k = _sizes(cfg)
    tokens = batch * seq
    attn = k["attn"] * 2 * k["h"] * k["hd"] * seq * seq * batch
    ssd = k["mamba"] * 4 * k["n"] * k["p"] * k["heads"] * tokens
    head = 2 * cfg["vocab_size"] * k["d"] * batch
    return 2 * matmul_params(cfg) * tokens + attn + ssd + head


def ssd_scan(cfg: dict, batch: int, seq: int) -> tuple:
    """(flops, bytes) of one mamba layer's SSD scan over ``batch`` prompts
    of ``seq`` tokens in the chunked dual form at ``SSD_CHUNK``: within a
    chunk C B^T and the masked scores times x over the causal half, the
    chunk's state from B and x, the carried state read by C, the state
    passed on; x, B, C (bf16) and dt (float32) read once, y (bf16) written
    once."""
    k = _sizes(cfg)
    q = min(SSD_CHUNK, seq)
    n, p, heads = k["n"], k["p"], k["heads"]
    tokens = batch * seq
    flops = tokens * (q * n + q * p * heads + 4 * n * p * heads) \
        + batch * (seq // q) * 2 * n * p * heads
    nbytes = tokens * (2 * k["di"] + 2 * 2 * n + 4 * heads + 2 * k["di"])
    return flops, nbytes


def ssd_bound_s(cfg: dict, batch: int, seq: int) -> float:
    """The least time of every mamba layer's scan over one batch: the
    larger of the bytes over HBM and the flops over the bf16 peak."""
    one = roofline.bound_s(*ssd_scan(cfg, batch, seq),
                           roofline.BF16_FLOP_PER_S)
    return _sizes(cfg)["mamba"] * one


def b9_bound_s(cfg: dict, batch: int, seq: int) -> float:
    """The least time of every attention layer's B9 launch over one batch:
    ``roofline.flash_fwd``'s causal count at the layer's heads, the larger
    of its bytes over HBM and its flops over the bf16 peak."""
    k = _sizes(cfg)
    one = roofline.bound_s(*roofline.flash_fwd(
        batch, k["h"], k["kv"], seq, seq, k["hd"], True),
        roofline.BF16_FLOP_PER_S)
    return k["attn"] * one
