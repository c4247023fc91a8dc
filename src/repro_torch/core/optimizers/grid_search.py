"""Exhaustive / budgeted grid search."""
from __future__ import annotations

from typing import Any, Dict

from ..tunable import TunableSpace
from .base import Optimizer

__all__ = ["GridSearch"]


class GridSearch(Optimizer):
    def __init__(self, space: TunableSpace, seed: int = 0, per_dim: int = 8, shuffle: bool = True):
        super().__init__(space, seed)
        self._grid = space.grid(per_dim)
        if shuffle:
            self.rng.shuffle(self._grid)
        self._i = 0

    def _ask(self) -> Dict[str, Any]:
        cfg = self._grid[self._i % len(self._grid)]
        self._i += 1
        return dict(cfg)

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self._grid)
