"""Ask/tell optimizers over a TunableSpace — the port of
``repro/core/optimizers``, numpy backend only (``backend="jax"`` and the
``bo_jax*`` names are refused)."""
from .base import Observation, Optimizer, optimize
from .bayesopt import BACKENDS, BayesOpt
from .gaussian_process import GP, KERNELS
from .grid_search import GridSearch
from .random_search import OneAtATime, RandomSearch

__all__ = [
    "Observation", "Optimizer", "optimize",
    "BayesOpt", "GP", "KERNELS", "GridSearch", "OneAtATime", "RandomSearch",
    "make_optimizer", "set_optimizer_defaults", "optimizer_defaults",
]

# Process-wide defaults applied by make_optimizer when the caller does not
# pin them (``optimizer.backend=...`` from launch/tuning.py).
_DEFAULTS: dict = {"backend": "numpy"}


def set_optimizer_defaults(**kw) -> None:
    unknown = set(kw) - set(_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown optimizer defaults {sorted(unknown)}")
    if "backend" in kw and kw["backend"] not in BACKENDS:
        raise ValueError(f"unknown backend {kw['backend']!r}: the port has {BACKENDS}")
    _DEFAULTS.update(kw)


def optimizer_defaults() -> dict:
    return dict(_DEFAULTS)


def make_optimizer(name: str, space, seed: int = 0, **kw):
    name = name.lower()
    if name in ("rs", "random", "random_search"):
        return RandomSearch(space, seed, **kw)
    if name in ("grid", "grid_search"):
        return GridSearch(space, seed, **kw)
    if name in ("oaat", "one_at_a_time"):
        return OneAtATime(space, seed, **kw)
    if name in ("bo", "bayesopt", "gp"):
        kw.setdefault("backend", _DEFAULTS["backend"])
        return BayesOpt(space, seed, **kw)
    if name in ("bo_rbf",):
        kw.setdefault("backend", _DEFAULTS["backend"])
        return BayesOpt(space, seed, kernel="rbf", **kw)
    if name in ("bo_matern32", "bo_matern"):
        kw.setdefault("backend", _DEFAULTS["backend"])
        return BayesOpt(space, seed, kernel="matern32", **kw)
    if name.startswith("bo_jax"):
        raise ValueError(f"optimizer {name!r} needs the jax engine; the port has the numpy "
                         "backend only")
    raise ValueError(f"unknown optimizer {name!r}")
