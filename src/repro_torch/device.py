"""Device selection shared by the port's entry points.

The port runs on the card by default.  Asking for CUDA on a machine that
has none raises: nothing quietly continues on the CPU.
"""

from __future__ import annotations

import torch



def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
