"""Ask/tell optimizers over a TunableSpace — the port of
``repro/core/optimizers``.  BO has the numpy backend and the torch engine
(``backend="torch"``, the names ``bo_torch*``); the reference's
``backend="jax"`` and ``bo_jax*`` names are refused with their torch
counterparts named."""
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
# pin them: the launch CLI flips every BO it builds to the torch engine with
# one override (``optimizer.backend=torch``, see launch/tuning.py); ``device``
# is the torch engine's.
_DEFAULTS: dict = {"backend": "numpy", "device": "cuda"}
_JAX_COUNTERPART = ("the port's torch engine: backend='torch', or bo_torch, bo_torch_matern32, "
                    "bo_torch_rbf")


def set_optimizer_defaults(**kw) -> None:
    unknown = set(kw) - set(_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown optimizer defaults {sorted(unknown)}")
    if kw.get("backend") == "jax":
        raise ValueError(f"backend 'jax' is the reference's; use {_JAX_COUNTERPART}")
    if "backend" in kw and kw["backend"] not in BACKENDS:
        raise ValueError(f"unknown backend {kw['backend']!r}: the port has {BACKENDS}")
    if "device" in kw and not isinstance(kw["device"], str):
        raise ValueError(f"device must be a string such as 'cuda' or 'cpu': {kw['device']!r}")
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
    if name.startswith("bo") or name in ("bayesopt", "gp"):
        kw.setdefault("device", _DEFAULTS["device"])
    if name in ("bo", "bayesopt", "gp"):
        kw.setdefault("backend", _DEFAULTS["backend"])
        return BayesOpt(space, seed, **kw)
    if name in ("bo_rbf",):
        kw.setdefault("backend", _DEFAULTS["backend"])
        return BayesOpt(space, seed, kernel="rbf", **kw)
    if name in ("bo_matern32", "bo_matern"):
        kw.setdefault("backend", _DEFAULTS["backend"])
        return BayesOpt(space, seed, kernel="matern32", **kw)
    if name in ("bo_torch", "bo_torch_matern32"):
        return BayesOpt(space, seed, kernel="matern32", backend="torch", **kw)
    if name in ("bo_torch_rbf",):
        return BayesOpt(space, seed, kernel="rbf", backend="torch", **kw)
    if name.startswith("bo_jax"):
        raise ValueError(f"optimizer {name!r} is the reference's jax engine; use "
                         f"{_JAX_COUNTERPART}")
    raise ValueError(f"unknown optimizer {name!r}")
