"""Training steps of the port (the counterpart of ``repro.train``)."""

from repro_torch.train.step import make_sgd_step

__all__ = ["make_sgd_step"]
