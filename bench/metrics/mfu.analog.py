"""The whole apply's share of the card's float32 peak over the window:
the program's operations a block (B6's count, bench/roofline.py) times the
applies, over the window's seconds and 67 TFLOP/s, in %."""

from bench import roofline


def read(records):
    if "apply_flops" not in records:
        return None
    rate = records["apply_flops"] * records["applies"] / records["window_s"]
    return 100.0 * rate / roofline.FP32_FLOP_PER_S
