"""The yardstick's counts at the cells' shapes against numbers worked by
hand, and the weights' layout against the program's."""

import json
from pathlib import Path

import pytest
import torch

from bench import roofline
from bench.reference import dense_lm

BENCH = Path(__file__).resolve().parent
GRANITE = json.loads((BENCH / "configs" / "granite-3-2b.json").read_text())


def test_b6_count_at_the_analog_cell():
    # 4 layers x 4 x 4 tiles x 2 meshes x 120 cells = 15360 cells;
    # a row: 28 x 15360 + 20 x 4 x 16 x 16 + 4 x 4 x 4 x 16 = 451584 flops
    flops, nbytes = roofline.deep_grid_fwd(65536, 4, 4, 4, 16)
    assert flops == 65536 * 451584 == 29_595_009_024
    # 8 B in and 4 B out a channel and row; 8 floats a cell; 6 a channel
    assert nbytes == (8 + 4) * 65536 * 64 + 4 * 8 * 15360 + 4 * 6 * 1024
    assert nbytes == 50_847_744
    bound = roofline.bound_s(flops, nbytes, roofline.FP32_FLOP_PER_S)
    assert bound == pytest.approx(29_595_009_024 / 67e12)


def test_b9_count_at_the_prefill_cell():
    # causal: half of 4 B H S^2 hd; q, o over 32 heads, k, v over 8
    flops, nbytes = roofline.flash_fwd(8, 32, 8, 1024, 1024, 64, True)
    assert flops == 34_359_738_368
    assert nbytes == 2 * 8 * 64 * (2 * 32 * 1024 + 2 * 8 * 1024) == 83_886_080
    assert roofline.bound_s(flops, nbytes, roofline.BF16_FLOP_PER_S) == \
        pytest.approx(34_359_738_368 / 989e12)


def test_granite_model_flops():
    # a layer: 2048 x 64 x (32 + 2 x 8) + 32 x 64 x 2048 + 3 x 2048 x 8192
    layer = 6_291_456 + 4_194_304 + 50_331_648
    head = 49155 * 2048
    assert roofline.dense_matmul_params(GRANITE) == 20 * layer + head \
        == 1_317_017_600
    attn_512 = 20 * 2 * 32 * 64 * 512 * 512         # causal, a sequence
    assert roofline.train_step_flops(GRANITE, 8, 512) == \
        6 * 1_317_017_600 * 4096 + 3 * 8 * attn_512 == 32_882_420_613_120
    attn_1024 = 20 * 2 * 32 * 64 * 1024 * 1024
    assert roofline.prefill_flops(GRANITE, 8, 1024) == \
        2 * 20 * layer * 8192 + 2 * head * 8 + 8 * attn_1024 \
        == 20_617_453_731_840


def test_weights_layout_is_the_programs():
    from repro_torch.models import Model

    from bench.drivers import lm_common

    small = dict(GRANITE, num_hidden_layers=2, hidden_size=64,
                 num_attention_heads=4, num_key_value_heads=2,
                 intermediate_size=128, vocab_size=512)
    ours = dense_lm.make_params(small, 2**31 + 5, "cpu")
    theirs = Model(lm_common.model_config(small, {"attn_impl": "xla"})).init(
        torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        return {k: tuple(v.shape) for k, v in dense_lm.slices(tree).items()}

    assert shapes(ours) == shapes(theirs)
    total = sum(t.numel() for t in dense_lm.slices(ours).values())
    norms = 2 * 2 * 64 + 64
    assert total - norms == roofline.dense_matmul_params(small)
