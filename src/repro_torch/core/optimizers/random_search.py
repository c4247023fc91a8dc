"""Random Search — the paper's surprisingly strong baseline (claim C3)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from ..tunable import TunableSpace
from .base import Optimizer

__all__ = ["RandomSearch", "OneAtATime"]


class RandomSearch(Optimizer):
    def _ask(self) -> Dict[str, Any]:
        return self.space.sample(self.rng)


class OneAtATime(Optimizer):
    """Tune one parameter at a time (coordinate descent-ish) around the best.

    The paper's Fig. 3 contrasts "(1)" one-at-a-time lines with multi-parameter
    search; this optimizer reproduces the one-at-a-time strategy: each ask
    perturbs a single coordinate of the incumbent.
    """

    def __init__(self, space: TunableSpace, seed: int = 0, order: Optional[Sequence[str]] = None):
        super().__init__(space, seed)
        self._order = list(order or space.names)
        self._i = 0

    def _ask(self) -> Dict[str, Any]:
        base = dict(self.best.config) if self.best else self.space.defaults()
        name = self._order[self._i % len(self._order)]
        self._i += 1
        base[name] = self.space[name].sample(self.rng)
        return base
