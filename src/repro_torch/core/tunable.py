"""Tunable parameters ("auto-parameters" in MLOS terms) and search spaces.

The paper declares system constants tunable via language-native annotations
(C# attributes over C++ constants).  The Python idiom here is a declarative
``Tunable`` descriptor plus a ``TunableSpace`` that supports:

  * sampling (Random Search),
  * enumeration (Grid Search),
  * a continuous [0,1]^d embedding (Bayesian Optimization over GP),

so every optimizer works over any component.  A copy of the reference
package's module (numpy only), kept here so the port imports nothing of it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Tunable", "TunableSpace", "Int", "Float", "Categorical", "Bool"]


@dataclasses.dataclass(frozen=True)
class Tunable:
    """One tunable parameter: type, domain and default.

    kind:
      - "int":   integer in [low, high]; optionally log-scaled
      - "float": float in [low, high]; optionally log-scaled
      - "categorical": one of ``choices`` (any hashable values)
    """

    name: str
    kind: str
    default: Any
    low: Optional[float] = None
    high: Optional[float] = None
    log: bool = False
    choices: Optional[Tuple[Any, ...]] = None
    description: str = ""

    def __post_init__(self) -> None:
        if self.kind not in ("int", "float", "categorical"):
            raise ValueError(f"unknown tunable kind {self.kind!r}")
        if self.kind == "categorical":
            if not self.choices:
                raise ValueError(f"{self.name}: categorical needs choices")
            if self.default not in self.choices:
                raise ValueError(f"{self.name}: default {self.default!r} not in choices")
        else:
            if self.low is None or self.high is None or self.low > self.high:
                raise ValueError(f"{self.name}: bad range [{self.low}, {self.high}]")
            if self.log and self.low <= 0:
                raise ValueError(f"{self.name}: log scale requires low > 0")
            if not (self.low <= self.default <= self.high):
                raise ValueError(f"{self.name}: default {self.default} outside range")

    # ------------------------------------------------------------------ sampling
    def sample(self, rng: np.random.Generator) -> Any:
        if self.kind == "categorical":
            return self.choices[int(rng.integers(len(self.choices)))]
        return self.decode(float(rng.random()))

    def grid(self, n: int = 8) -> List[Any]:
        """Up-to-n representative values spanning the domain."""
        if self.kind == "categorical":
            return list(self.choices)
        us = np.linspace(0.0, 1.0, n)
        vals: List[Any] = []
        for u in us:
            v = self.decode(float(u))
            if v not in vals:
                vals.append(v)
        return vals

    # ------------------------------------------------------ [0,1] unit embedding
    def encode(self, value: Any) -> float:
        """Map a concrete value into [0,1] (for the GP surrogate).

        Delegates to :meth:`encode_array` so scalar and batch paths share
        one transcendental implementation — the optimizer engines dedup
        encoded rows by raw bytes, and the two BO backends encode through
        different paths (scalar on tell, batch on ask), so a 1-ULP
        np.log/math.log divergence would split identical configs.
        """
        return float(self.encode_array([value])[0])

    def decode(self, u: float) -> Any:
        """Map a point of [0,1] back into the domain (inverse of encode).

        Delegates to :meth:`decode_array` — one implementation for scalar
        and batch paths (see :meth:`encode`).
        """
        return self.decode_array(np.array([float(u)]))[0]

    def validate(self, value: Any) -> Any:
        if self.kind == "categorical":
            if value not in self.choices:
                raise ValueError(f"{self.name}: {value!r} not in {self.choices}")
            return value
        v = float(value)
        if not (self.low <= v <= self.high):
            raise ValueError(f"{self.name}: {v} outside [{self.low}, {self.high}]")
        return int(round(v)) if self.kind == "int" else v

    # ------------------------------------------------- vectorized embedding
    # Batch twins of encode/decode.  They must agree bit-for-bit with the
    # scalar paths: the optimizer engines de-duplicate encoded rows by raw
    # bytes, so a scalar/vector drift would split identical configs.
    def encode_array(self, values: Sequence[Any]) -> np.ndarray:
        if self.kind == "categorical":
            idx = np.array([self.choices.index(v) for v in values], dtype=np.float64)
            return (idx + 0.5) / len(self.choices)
        lo, hi = float(self.low), float(self.high)
        v = np.asarray([float(x) for x in values], dtype=np.float64)
        if self.log:
            if np.any(v <= 0):  # np.log would silently yield NaN/-inf here
                raise ValueError(f"{self.name}: log scale requires positive values")
            lo, hi, v = math.log(lo), math.log(hi), np.log(v)
        if hi == lo:
            return np.full(len(v), 0.5)
        return np.minimum(1.0, np.maximum(0.0, (v - lo) / (hi - lo)))

    def decode_array(self, us: np.ndarray) -> List[Any]:
        u = np.minimum(1.0, np.maximum(0.0, np.asarray(us, dtype=np.float64)))
        if self.kind == "categorical":
            idx = np.minimum(len(self.choices) - 1, (u * len(self.choices)).astype(np.int64))
            return [self.choices[int(i)] for i in idx]
        lo, hi = float(self.low), float(self.high)
        if self.log:
            v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            v = lo + u * (hi - lo)
        if self.kind == "int":
            return [int(x) for x in np.clip(np.round(v), self.low, self.high).astype(np.int64)]
        return [float(x) for x in v]


# Convenience constructors -------------------------------------------------------
def Int(name: str, default: int, low: int, high: int, log: bool = False, description: str = "") -> Tunable:
    return Tunable(name, "int", default, low=low, high=high, log=log, description=description)


def Float(name: str, default: float, low: float, high: float, log: bool = False, description: str = "") -> Tunable:
    return Tunable(name, "float", default, low=low, high=high, log=log, description=description)


def Categorical(name: str, default: Any, choices: Sequence[Any], description: str = "") -> Tunable:
    return Tunable(name, "categorical", default, choices=tuple(choices), description=description)


def Bool(name: str, default: bool, description: str = "") -> Tunable:
    return Categorical(name, default, (False, True), description=description)


class TunableSpace:
    """An ordered collection of Tunables — the component's search space."""

    def __init__(self, tunables: Sequence[Tunable]):
        names = [t.name for t in tunables]
        if len(set(names)) != len(names):
            raise ValueError("duplicate tunable names")
        self._tunables: Dict[str, Tunable] = {t.name: t for t in tunables}

    # mapping-ish API
    def __iter__(self) -> Iterator[Tunable]:
        return iter(self._tunables.values())

    def __len__(self) -> int:
        return len(self._tunables)

    def __contains__(self, name: str) -> bool:
        return name in self._tunables

    def __getitem__(self, name: str) -> Tunable:
        return self._tunables[name]

    @property
    def names(self) -> List[str]:
        return list(self._tunables)

    def defaults(self) -> Dict[str, Any]:
        return {t.name: t.default for t in self}

    def validate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        unknown = set(config) - set(self._tunables)
        if unknown:
            raise ValueError(f"unknown tunables {sorted(unknown)}")
        out = self.defaults()
        for k, v in config.items():
            out[k] = self._tunables[k].validate(v)
        return out

    def subset(self, names: Sequence[str]) -> "TunableSpace":
        return TunableSpace([self._tunables[n] for n in names])

    # optimizer-facing API
    def sample(self, rng: np.random.Generator) -> Dict[str, Any]:
        return {t.name: t.sample(rng) for t in self}

    def grid(self, per_dim: int = 8) -> List[Dict[str, Any]]:
        configs: List[Dict[str, Any]] = [{}]
        for t in self:
            configs = [dict(c, **{t.name: v}) for c in configs for v in t.grid(per_dim)]
        return configs

    def encode(self, config: Dict[str, Any]) -> np.ndarray:
        return np.array([t.encode(config[t.name]) for t in self], dtype=np.float64)

    def decode(self, x: np.ndarray) -> Dict[str, Any]:
        return {t.name: t.decode(float(u)) for t, u in zip(self, np.asarray(x, dtype=np.float64))}

    def encode_batch(self, configs: Sequence[Dict[str, Any]]) -> np.ndarray:
        """Vectorized :meth:`encode` over a batch of configs → ``(B, d)``.

        One numpy op per *dimension* instead of one Python call per *value* —
        the per-ask history embedding of the optimizers is O(d) dispatches
        regardless of history length.
        """
        if not configs:
            return np.zeros((0, len(self)), dtype=np.float64)
        cols = [t.encode_array([c[t.name] for c in configs]) for t in self]
        return np.stack(cols, axis=1)

    def decode_batch(self, X: np.ndarray) -> List[Dict[str, Any]]:
        """Vectorized :meth:`decode` over ``(B, d)`` rows → list of configs."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        cols = [t.decode_array(X[:, j]) for j, t in enumerate(self)]
        names = self.names
        return [dict(zip(names, row)) for row in zip(*cols)] if len(X) else []

    def to_json(self) -> List[Dict[str, Any]]:
        return [dataclasses.asdict(t) for t in self]

    @staticmethod
    def from_json(items: List[Dict[str, Any]]) -> "TunableSpace":
        ts = []
        for it in items:
            it = dict(it)
            if it.get("choices") is not None:
                it["choices"] = tuple(it["choices"])
            ts.append(Tunable(**it))
        return TunableSpace(ts)
