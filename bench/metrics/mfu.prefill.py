"""The prefill's share of the card's bf16 peak over the window: the
model's flops of every prefilled batch (2 per matmul weight and token, the
head on the last position, causal attention; bench/roofline.py) over the
window's seconds and 989 TFLOP/s, in %."""

from bench import roofline


def read(records):
    if "flops" not in records or "prompt_tokens" not in records:
        return None
    return 100.0 * records["flops"] / records["window_s"] \
        / roofline.BF16_FLOP_PER_S
