"""The yardstick's peaks and the work of each measured kernel and step,
counted from the algorithm at the cell's shapes, so that a count reads the
same work whatever implements it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): HBM
3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s, bf16 on the tensor
cores 989 TFLOP/s.  A kernel's bound is the larger of its bytes over the
HBM rate and its operations over the peak of its precision.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# a 2x2 complex cell on one row: two outputs, each two complex products
# (6 flops) and a complex add (2)
FLOPS_PER_CELL = 28
# per row and tile channel of a deep grid's layer: the three diagonal gain
# products (6 each) and the row combine's complex add (2)
FLOPS_PER_TILE_CHANNEL = 20
# per row channel of a layer: the detector's |.| (two products, an add and
# a square root)
FLOPS_PER_ROW_CHANNEL = 4


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def mesh_cells(n: int) -> int:
    """Cells of an n-channel unitary mesh (paper Eq. 28)."""
    return n * (n - 1) // 2


def deep_grid_fwd(rows: int, depth: int, to: int, ti: int, n: int) -> tuple:
    """(flops, bytes) of one deep-grid forward with a magnitude readout
    (kernel B6): every tile's two unitary meshes, its gains and its row's
    combine and detection, on ``rows`` complex64 input rows of ``ti * n``
    channels and float32 outputs of ``to * n``; the cells (float32 2x2
    complex, 8 numbers each) and the gains (12 numbers a channel pair) read
    once."""
    tiles = to * ti
    cells = 2 * mesh_cells(n) * tiles * depth
    flops = rows * (FLOPS_PER_CELL * cells
                    + FLOPS_PER_TILE_CHANNEL * depth * tiles * n
                    + FLOPS_PER_ROW_CHANNEL * depth * to * n)
    nbytes = (8 * rows * ti * n + 4 * rows * to * n
              + 4 * 8 * cells + 4 * 6 * depth * tiles * n)
    return flops, nbytes


def flash_fwd(b: int, h: int, kv_heads: int, sq: int, skv: int, hd: int,
              causal: bool) -> tuple:
    """(flops, bytes) of one attention forward in bf16 (kernel B9): QK^T
    and PV (half the score block under a causal mask), q and o over the
    q heads and k, v over the KV heads moved once."""
    flops = 4 * b * h * sq * skv * hd * (0.5 if causal else 1.0)
    nbytes = 2 * b * hd * (2 * h * sq + 2 * kv_heads * skv)
    return flops, nbytes


def dense_matmul_params(cfg: dict) -> int:
    """Weights that a token meets in matmuls in a dense decoder: the
    attention and MLP projections of every layer and the output head (the
    input embedding is a lookup)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    attn = d * hd * (h + 2 * kv) + h * hd * d
    mlp = 3 * d * f
    return cfg["num_hidden_layers"] * (attn + mlp) + cfg["vocab_size"] * d


def attention_flops_fwd(cfg: dict, s: int) -> float:
    """Causal attention's forward flops a sequence of ``s`` tokens."""
    h = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // h
    return cfg["num_hidden_layers"] * 2 * h * hd * s * s


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model flops of one training step: 6 flops per matmul weight and
    token (forward and backward) and causal attention's forward and
    backward (three times its forward)."""
    return (6 * dense_matmul_params(cfg) * batch * seq
            + 3 * batch * attention_flops_fwd(cfg, seq))


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model flops of prefilling ``batch`` prompts of ``seq`` tokens with
    last-position logits: the blocks over every token, the head over one
    token a prompt, causal attention."""
    head = cfg["vocab_size"] * cfg["hidden_size"]
    blocks = dense_matmul_params(cfg) - head
    return (2 * blocks * batch * seq + 2 * head * batch
            + batch * attention_flops_fwd(cfg, seq))
