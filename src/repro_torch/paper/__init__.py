"""Paper reproduction applications (Secs. III-IV): inference and training."""

from repro_torch.paper.mnist_rfnn import MnistRFNN
from repro_torch.paper.rfnn2x2 import RFNN2x2

__all__ = ["MnistRFNN", "RFNN2x2"]
