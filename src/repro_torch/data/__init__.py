"""Data: procedural digits (MNIST stand-in) and the paper's 2x2 toy sets.

numpy and scipy only; copies of the JAX package's ``data/digits.py`` and
``data/toys.py``.
"""

from repro_torch.data.digits import load_digits
from repro_torch.data.toys import make_toy_dataset

__all__ = ["load_digits", "make_toy_dataset"]
