"""Paper reproduction applications (Secs. III-V): inference, training and
the Sec.-V efficiency model."""

from repro_torch.paper.efficiency import table2_rows
from repro_torch.paper.mnist_rfnn import MnistRFNN
from repro_torch.paper.rfnn2x2 import RFNN2x2

__all__ = ["MnistRFNN", "RFNN2x2", "table2_rows"]
