"""repro_torch.serving — the serving engine on torch (analog programs and LMs).

:class:`ServingEngine` (fixed-slot ticks + async dispatch), :class:`Request`,
the :class:`ServableProgram` protocol and :func:`as_servable`.  The retired
batchers (``ContinuousBatcher``, ``AnalogTickBatcher``, ``AnalogRequest``)
stay importable as deprecated shims from :mod:`repro_torch.serving.batcher`;
reaching them through this package works too.
"""

from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.servable import ServableProgram, as_servable

__all__ = ["Request", "ServableProgram", "ServingEngine", "as_servable"]

_DEPRECATED = {"AnalogRequest", "AnalogTickBatcher", "ContinuousBatcher"}


def __getattr__(name):
    if name in _DEPRECATED:
        from repro_torch.serving import batcher

        return getattr(batcher, name)
    raise AttributeError(
        f"module 'repro_torch.serving' has no attribute {name!r}")


def __dir__():
    return sorted(set(__all__) | _DEPRECATED)
