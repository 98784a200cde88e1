"""Optimizers: AdamW and learning-rate schedules."""

from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["AdamW", "OptState", "cosine_schedule", "linear_warmup"]
