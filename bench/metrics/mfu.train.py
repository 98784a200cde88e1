"""The train step's share of the card's bf16 peak over the window: the
model's flops a step (6 per matmul weight and token, and causal
attention's forward and backward; bench/roofline.py) times the steps, over
the window's seconds and 989 TFLOP/s, in %."""

from bench import roofline


def read(records):
    if "step_flops" not in records:
        return None
    rate = records["step_flops"] * records["steps"] / records["window_s"]
    return 100.0 * rate / roofline.BF16_FLOP_PER_S
