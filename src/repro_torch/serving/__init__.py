"""repro_torch.serving — the analog serving engine on torch.

:class:`ServingEngine` (fixed-slot ticks + async dispatch), :class:`Request`,
the :class:`ServableProgram` protocol and :func:`as_servable`.
"""

from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.servable import ServableProgram, as_servable

__all__ = ["Request", "ServableProgram", "ServingEngine", "as_servable"]
