"""Activation functions used by the paper's networks (Sec. IV).

The analog layer's activation is magnitude detection (``abs``): it is what
the power detector physically measures.  All other activations run in
digital post-processing, exactly as in the paper.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def abs_detect(x: torch.Tensor) -> torch.Tensor:
    """Magnitude detection, the analog layer's natural activation."""
    return x.abs()


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


ACTIVATIONS = {
    "abs": abs_detect,
    "sigmoid": sigmoid,
    "leaky_relu": leaky_relu,
    "softmax": softmax,
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def get_activation(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError as e:
        raise KeyError(f"unknown activation {name!r}; have "
                       f"{sorted(ACTIVATIONS)}") from e
