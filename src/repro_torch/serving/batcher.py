"""Deprecated serving shims — use :mod:`repro_torch.serving.engine`.

The JAX package's ``serving/batcher.py`` on torch: the two retired serving
loops (``ContinuousBatcher`` for LM decode, ``AnalogTickBatcher`` for
analog ticks) are one :class:`repro_torch.serving.ServingEngine`, and
``Request``/``AnalogRequest`` one :class:`repro_torch.serving.Request`.
These aliases keep old call sites working; they emit
``DeprecationWarning``.  As on the engine, ``device=`` picks the card
(CUDA when None) and ``mesh=``/``data_axis=`` split each tick's panel by
batch over the mesh's data axis.
"""

from __future__ import annotations

import warnings

from repro_torch.serving.engine import Request as _Request
from repro_torch.serving.engine import ServingEngine

__all__ = ["AnalogRequest", "AnalogTickBatcher", "ContinuousBatcher",
           "Request"]

#: Deprecated alias — construct :class:`repro_torch.serving.Request` directly.
Request = _Request


def _warn(old: str, new: str) -> None:
    warnings.warn(f"repro_torch.serving.{old} is deprecated; use {new}",
                  DeprecationWarning, stacklevel=3)


class AnalogRequest(_Request):
    """Deprecated — ``repro_torch.serving.Request(rid, features=...)``."""

    def __init__(self, rid, features=None, *, deadline_ticks=None, **kw):
        _warn("AnalogRequest", "repro_torch.serving.Request(features=...)")
        super().__init__(rid, features=features,
                         deadline_ticks=deadline_ticks, **kw)


class AnalogTickBatcher(ServingEngine):
    """Deprecated — ``repro_torch.serving.ServingEngine``.

    Same constructor; ``stats`` keeps the old three-counter shape
    (``dropped`` maps to the engine's ``expired``).
    """

    def __init__(self, model, params=None, *, slots, mesh=None,
                 data_axis="data", failure_injector=None, recovery=None,
                 device=None):
        _warn("AnalogTickBatcher", "repro_torch.serving.ServingEngine")
        super().__init__(model, params, slots=slots, mesh=mesh,
                         data_axis=data_axis, device=device,
                         failure_injector=failure_injector,
                         recovery=recovery)

    @property
    def stats(self):
        c = self.slo.counters
        return {"served": c["served"], "dropped": c["expired"],
                "recovered": c["recovered"]}


class ContinuousBatcher(ServingEngine):
    """Deprecated — ``repro_torch.serving.ServingEngine`` (LM path)."""

    def __init__(self, model, params, *, slots, max_len, device=None):
        _warn("ContinuousBatcher", "repro_torch.serving.ServingEngine")
        super().__init__(model, params, slots=slots, max_len=max_len,
                         device=device)

    def tick(self, sample=None):
        if sample is not None:
            self._impl.sample = sample
        return super().tick()
