"""Optimizers: AdamW."""

from repro_torch.optim.adamw import AdamW, OptState

__all__ = ["AdamW", "OptState"]
