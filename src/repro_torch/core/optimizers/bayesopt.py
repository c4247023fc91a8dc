"""Bayesian Optimization over a TunableSpace (GP surrogate + EI/UCB).

Minimization convention.  The space is embedded into [0,1]^d via
``TunableSpace.encode``; candidates are a random pool plus local
perturbations of the incumbent, scored by the acquisition function.

The port of ``repro/core/optimizers/bayesopt.py``.  Two interchangeable
surrogate backends (``backend=`` ctor arg):

  * ``"numpy"`` — the reference path: scipy GP refit from scratch per ask.
  * ``"torch"`` — :class:`~.engine.TorchGP` on ``device`` (the card unless
    the caller asks for the CPU): incremental Cholesky on tell, one
    captured program per ask, and batchable across sessions via
    :class:`~.engine.BatchedBayesOpt`.  The counterpart of the reference's
    ``"jax"`` backend, which the port refuses.

Candidate generation (and therefore the rng stream) is shared between the
backends, so with hyperparameter fitting disabled the two are argmax-
equivalent.  With the same seed and observations the port's numpy backend
proposes the reference's numpy configs, ask for ask.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
from scipy.stats import norm

from ..tunable import TunableSpace
from .base import Observation, Optimizer
from .gaussian_process import GP

__all__ = ["BayesOpt", "dedup_rows", "BACKENDS"]

BACKENDS = ("numpy", "torch")


def dedup_rows(X: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse duplicate encoded rows, keeping the best (lowest) y per row.

    First-occurrence order is preserved.  Categoricals collapse many configs
    onto one encoding; duplicates would make the kernel matrix singular.
    """
    index: Dict[bytes, int] = {}
    keep: list = []
    yd: list = []
    for i in range(len(X)):
        key = np.ascontiguousarray(X[i]).tobytes()
        j = index.get(key)
        if j is None:
            index[key] = len(keep)
            keep.append(i)
            yd.append(y[i])
        elif y[i] < yd[j]:
            yd[j] = y[i]
    return X[keep], np.asarray(yd, dtype=np.float64)


class BayesOpt(Optimizer):
    def __init__(
        self,
        space: TunableSpace,
        seed: int = 0,
        kernel: str = "matern32",
        acquisition: str = "ei",
        n_init: int = 5,
        n_candidates: int = 1024,
        ucb_beta: float = 2.0,
        backend: str = "numpy",
        fit_hypers: bool = True,
        device: Any = "cuda",
    ):
        super().__init__(space, seed)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: the port's BayesOpt has {BACKENDS}")
        self.kernel = kernel
        self.acquisition = acquisition
        self.n_init = n_init
        self.n_candidates = n_candidates
        self.ucb_beta = ucb_beta
        self.backend = backend
        self.fit_hypers = fit_hypers
        self.device = device     # the torch backend's; the numpy backend ignores it
        self._engine = None      # lazy: keeps torch out of numpy-only processes
        if backend == "torch":
            from .engine import require_device  # deferred import: torch is heavy

            self.device = require_device(device)
        # Warm-start state: prior observations from a related context seed
        # the surrogate (never history) and replay their incumbent first.
        self._prior_X = np.zeros((0, len(space)), dtype=np.float64)
        self._prior_y = np.zeros(0, dtype=np.float64)
        self._prior_best: Dict[str, Any] = {}
        self._prior_best_y = float("inf")
        self._prior_replayed = False

    # -- warm start -----------------------------------------------------------
    def inject_prior(self, observations) -> int:
        """Seed the surrogate with (config, value) pairs from a related
        context (campaign warm-start transfer).  Priors count toward the
        ``n_init`` quota, and the best prior config is replayed as the very
        first proposal.  Priors never enter ``history``: ``best`` stays a
        measured-here fact.
        """
        obs = [(dict(cfg), float(v)) for cfg, v in observations]
        if not obs:
            return 0
        X = self.space.encode_batch([cfg for cfg, _ in obs])
        y = np.asarray([v for _, v in obs], dtype=np.float64)
        X, y = dedup_rows(X, y)
        self._prior_X = np.concatenate([self._prior_X, X])
        self._prior_y = np.concatenate([self._prior_y, y])
        # The replay incumbent is the best over ALL injected batches.
        bi = int(np.argmin([v for _, v in obs]))
        if not self._prior_best or obs[bi][1] < self._prior_best_y:
            self._prior_best = self.space.validate(obs[bi][0])
            self._prior_best_y = obs[bi][1]
            self._prior_replayed = False
        if self.backend == "torch":
            self._engine_for().seed_observations(X, y)
        return len(y)

    @property
    def n_prior(self) -> int:
        return len(self._prior_y)

    @property
    def model_ready(self) -> bool:
        """Past the init phase with a live surrogate (priors count)."""
        return (len(self.history) >= 1
                and len(self.history) + self.n_prior >= self.n_init)

    # -- shared helpers -------------------------------------------------------
    def _engine_for(self):
        if self._engine is None:
            from .engine import TorchGP  # deferred import: torch is heavy

            self._engine = TorchGP(len(self.space), kernel=self.kernel,
                                   fit_hypers=self.fit_hypers, device=self.device)
        return self._engine

    def _on_tell(self, obs: Observation) -> None:
        if self.backend == "torch":
            self._engine_for().observe(self.space.encode(obs.config), obs.value)

    def _candidates(self, inc: np.ndarray) -> np.ndarray:
        """Random pool + local perturbations of the incumbent (the
        reference's rng draw order)."""
        d = len(self.space)
        pool = self.rng.random((self.n_candidates, d))
        local = np.clip(
            inc[None, :] + 0.08 * self.rng.standard_normal((self.n_candidates // 4, d)),
            0, 1)
        return np.concatenate([pool, local], axis=0)

    def _acq(self, mu: np.ndarray, sd: np.ndarray, best: float) -> np.ndarray:
        if self.acquisition == "ucb":  # lower-confidence bound for minimization
            return -(mu - self.ucb_beta * sd)
        imp = best - mu
        z = imp / np.maximum(sd, 1e-12)
        ei = imp * norm.cdf(z) + sd * norm.pdf(z)
        return np.where(sd > 1e-12, ei, 0.0)

    def _model_inputs(self):
        """(engine, candidates, acq_id, beta) for the batched ask path.
        Draws this ask's candidate pool: call once per ask."""
        eng = self._engine_for()
        cand = self._candidates(eng.incumbent())
        return eng, cand, (1 if self.acquisition == "ucb" else 0), self.ucb_beta

    # -- ask ------------------------------------------------------------------
    def _ask(self) -> Dict[str, Any]:
        if self._prior_best and not self._prior_replayed and not self.history:
            # Incumbent replay: measure the warm-start source's best first.
            self._prior_replayed = True
            return dict(self._prior_best)
        if len(self.history) + self.n_prior < self.n_init:
            return self.space.sample(self.rng)
        if self.backend == "torch":
            eng, cand, _, beta = self._model_inputs()
            idx, _ = eng.suggest(cand, self.acquisition, beta)
            return self.space.decode(cand[idx])
        X = self.space.encode_batch([o.config for o in self.history])
        y = np.array([o.value for o in self.history])
        if self.n_prior:
            # Priors seed the surrogate exactly like the torch engine's padded
            # buffers: prior rows first (injection order), history folded on
            # top keep-best by the dedup below.
            X = np.concatenate([self._prior_X, X])
            y = np.concatenate([self._prior_y, y])
        X, y = dedup_rows(X, y)
        gp = GP(kernel=self.kernel, fit_hypers=self.fit_hypers).fit(X, y)
        cand = self._candidates(X[int(np.argmin(y))])
        mu, sd = gp.predict(cand)
        score = self._acq(mu, sd, float(y.min()))
        return self.space.decode(cand[int(np.argmax(score))])
