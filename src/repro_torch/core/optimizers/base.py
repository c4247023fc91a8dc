"""Optimizer interface: ask/tell over a TunableSpace (minimization)."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..tunable import TunableSpace

__all__ = ["Optimizer", "Observation", "optimize"]


class Observation:
    __slots__ = ("config", "value")

    def __init__(self, config: Dict[str, Any], value: float):
        self.config = config
        self.value = float(value)

    def __repr__(self) -> str:
        return f"Observation({self.config}, {self.value:.6g})"


class Optimizer:
    """Base ask/tell optimizer; subclasses implement ``_ask``."""

    def __init__(self, space: TunableSpace, seed: int = 0):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.history: List[Observation] = []

    def ask(self) -> Dict[str, Any]:
        return self.space.validate(self._ask())

    def _ask(self) -> Dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    def tell(self, config: Dict[str, Any], value: float) -> None:
        obs = Observation(dict(config), value)
        self.history.append(obs)
        self._on_tell(obs)

    def inject_prior(self, observations: List[Tuple[Dict[str, Any], float]]) -> int:
        """Seed the optimizer with observations from a *related* context
        (cross-context warm start).  Priors inform the surrogate model only:
        they never enter ``history``, so ``best`` always names a config that
        was actually measured under THIS context.  Model-free optimizers
        ignore them; returns the number of observations absorbed.
        """
        return 0

    def _on_tell(self, obs: Observation) -> None:
        """Hook: an incremental backend folds the observation into its model
        state here instead of refitting from the full history at ask time."""

    @property
    def best(self) -> Optional[Observation]:
        return min(self.history, key=lambda o: o.value) if self.history else None

    def trace(self) -> List[float]:
        """Best-so-far trace (the 'strategy graph' of the paper's Fig. 3)."""
        out, cur = [], float("inf")
        for o in self.history:
            cur = min(cur, o.value)
            out.append(cur)
        return out


def optimize(
    opt: Optimizer,
    objective: Callable[[Dict[str, Any]], float],
    budget: int,
    callback: Optional[Callable[[int, Dict[str, Any], float], None]] = None,
) -> Tuple[Dict[str, Any], float]:
    """Run the ask/tell loop for ``budget`` evaluations; returns best (config, value)."""
    for i in range(budget):
        cfg = opt.ask()
        val = float(objective(cfg))
        opt.tell(cfg, val)
        if callback:
            callback(i, cfg, val)
    assert opt.best is not None
    return opt.best.config, opt.best.value
