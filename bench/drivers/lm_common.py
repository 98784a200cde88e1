"""What the LM drivers share: the port's model configuration from a
``config.json``-style file, and the comparison of norms leaf by leaf."""

from __future__ import annotations

import statistics


def model_config(cfg: dict, traffic: dict):
    """The port's ``ModelConfig`` of a dense decoder configuration, with
    the traffic's compute dtype, attention path and remat."""
    from repro_torch.models import ModelConfig

    if cfg["hidden_act"] != "silu":
        raise ValueError(f"no dense path for {cfg['hidden_act']!r}")
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        mlp_variant="swiglu", rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        dtype=cfg["torch_dtype"], attn_impl=traffic["attn_impl"],
        remat=traffic.get("remat", "none"))


def norm_gap(got: dict, want: dict, skip=()) -> tuple[float, str]:
    """The worst leaf's gap between two norms: ``|got - want|`` over the
    larger of that leaf's reference norm and the median leaf's.  Returns
    ``(gap, leaf)``; leaves named in ``skip`` are left out."""
    keys = [k for k in want if k not in skip]
    median = statistics.median(want[k] for k in keys)
    worst = (0.0, "")
    for k in keys:
        gap = abs(got[k] - want[k]) / max(want[k], median, 1e-30)
        if gap > worst[0]:
            worst = (gap, k)
    return worst
