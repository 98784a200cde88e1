"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus shape grid.

Ten assigned architectures (full + reduced smoke configs) and the four
assigned input shapes.  ``long_500k`` requires sub-quadratic attention and
runs only for the SSM/hybrid archs (see DESIGN.md shape-grid skips).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    gemma_2b,
    granite_3_2b,
    internvl2_2b,
    llama3_2_3b,
    llama4_maverick_400b_a17b,
    mamba2_780m,
    qwen2_moe_a2_7b,
    tinyllama_1_1b,
    whisper_large_v3,
    zamba2_1_2b,
)
from repro_torch.models.config import ModelConfig

_MODULES = {
    "internvl2-2b": internvl2_2b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "mamba2-780m": mamba2_780m,
    "whisper-large-v3": whisper_large_v3,
    "zamba2-1.2b": zamba2_1_2b,
    "granite-3-2b": granite_3_2b,
    "llama3.2-3b": llama3_2_3b,
    "gemma-2b": gemma_2b,
    "tinyllama-1.1b": tinyllama_1_1b,
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: archs whose attention is sub-quadratic-capable (SSM state / hybrid).
LONG_CONTEXT_ARCHS = ("mamba2-780m", "zamba2-1.2b")


def list_archs() -> list[str]:
    return sorted(_MODULES)


def get_config(name: str) -> ModelConfig:
    try:
        return _MODULES[name].CONFIG
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; have {list_archs()}") from e


def get_reduced(name: str) -> ModelConfig:
    return _MODULES[name].REDUCED


def shapes_for(name: str) -> list[str]:
    """The live shape cells for an arch (documented skips applied)."""
    get_config(name)  # raises on unknown arch
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if name in LONG_CONTEXT_ARCHS:
        shapes.append("long_500k")
    return shapes


def grid() -> list[tuple[str, str]]:
    """All live (arch, shape) cells."""
    return [(a, s) for a in list_archs() for s in shapes_for(a)]
