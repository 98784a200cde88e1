"""`ServableProgram` — the one surface the serving engine consumes.

Copied from the JAX package's ``serving/servable.py`` onto torch: anything
with ``apply(x) -> y`` plus the ``n_in``/``n_out``/``placement`` metadata
and a ``recover(dead_tiles)`` hook is servable, and :func:`as_servable`
adapts a model applied with explicit ``params`` onto it.

The protocol is structural (:func:`typing.runtime_checkable`), so a
program implements it without importing this module.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

__all__ = ["BoundAnalogModel", "ServableProgram", "as_servable"]


@runtime_checkable
class ServableProgram(Protocol):
    """What the serving engine needs from a compiled analog program.

    ``apply`` must accept a ``[B, n_in]`` panel and return ``[B, n_out]``.
    ``recover`` swaps in a replacement program after a mid-stream
    ``tile_down`` failure and must return a new `ServableProgram` (the
    engine rebinds to it; the dead instance is discarded).
    """

    n_in: int
    n_out: int
    placement: Any

    def apply(self, x: Any) -> Any: ...

    def recover(self, dead_tiles: Any, **kw: Any) -> "ServableProgram": ...


@dataclasses.dataclass(frozen=True)
class BoundAnalogModel:
    """Adapt a bare analog model (optionally with ``params``) to the protocol.

    Covers the pre-compile serving path: reference models whose ``apply``
    is either ``apply(x)`` or ``apply(params, x)``.  Metadata is
    introspected from the usual attribute spellings; ``recover`` delegates
    to the model when it has one and refuses otherwise (a bare model has
    no placement/calibration state to re-lower from).
    """

    model: Any
    params: Any = None

    def _dim(self, names: tuple[str, ...]) -> int:
        for name in names:
            v = getattr(self.model, name, None)
            if v is not None:
                return int(v)
        raise AttributeError(
            f"{type(self.model).__name__} exposes none of {names}; "
            "cannot infer panel width for the serving engine")

    @property
    def n_in(self) -> int:
        return self._dim(("n_in", "in_dim", "n"))

    @property
    def n_out(self) -> int:
        return self._dim(("n_out", "out_dim", "n"))

    @property
    def placement(self) -> Any:
        return getattr(self.model, "placement", None)

    def apply(self, x: Any) -> Any:
        if self.params is None:
            return self.model.apply(x)
        return self.model.apply(self.params, x)

    def recover(self, dead_tiles: Any, **kw: Any) -> "ServableProgram":
        rec = getattr(self.model, "recover", None)
        if rec is None:
            raise ValueError(
                f"{type(self.model).__name__} has no recover(); pass "
                "recovery= to the engine")
        return as_servable(rec(dead_tiles, **kw))


def as_servable(program: Any, params: Any = None) -> ServableProgram:
    """Coerce ``program`` to a :class:`ServableProgram`.

    Programs that already satisfy the protocol (the ``Compiled*Program``
    classes, or a previous :class:`BoundAnalogModel`) pass through
    untouched when no ``params`` are supplied; anything else is wrapped.
    """
    if params is None and isinstance(program, ServableProgram):
        return program
    return BoundAnalogModel(program, params)
