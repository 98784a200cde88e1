"""The Granite 4.0 hybrid prefill's share of the card's bf16 peak over the
window: ``mfu.prefill``'s formula over the model flops that this cell's
driver counts (bench/granite_counts.py: 2 per matmul weight and token, the
held experts at their expected share of a token's choices, causal
attention, the SSD's 4 N P H a token and mamba layer, the head on the last
position), in %."""

from bench import harness


def read(records):
    return harness.read_metric("mfu.prefill", records)
