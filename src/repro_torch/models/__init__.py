"""Model stack: configs, layers, the dense/VLM decoder, unified facade."""

from repro_torch.models.api import Model, cross_entropy
from repro_torch.models.config import ModelConfig

__all__ = ["Model", "ModelConfig", "cross_entropy"]
