"""Learning-rate schedules: the counterpart of the JAX package's
``repro.optim.schedules``.

Each schedule takes the step as a tensor, as ``AdamW.update`` passes it
(the int32 count after the update), and returns a float32 0-d tensor on the
step's device, computed in the JAX package's order of float32 operations.
"""

from __future__ import annotations

import math

import torch


def linear_warmup(base_lr: float, warmup_steps: int):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        return base_lr * torch.clamp(s / max(1, warmup_steps), max=1.0)
    return fn


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(1, warmup_steps), max=1.0)
        frac = torch.clamp((s - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
        return base_lr * warm * cos
    return fn
