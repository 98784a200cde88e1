"""Model stack: configs, layers, the decoder-LM families (dense, moe, ssm,
hybrid, vlm), the encoder-decoder, unified facade."""

from repro_torch.models.api import Model, cross_entropy
from repro_torch.models.config import ModelConfig

__all__ = ["Model", "ModelConfig", "cross_entropy"]
