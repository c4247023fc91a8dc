"""Gaussian-process regression with RBF and Matern kernels.

The paper's BO experiments use Gaussian Processes with plain and Matern-3/2
kernels (Fig. 3 legend).  This is a dependency-free (numpy/scipy) GP with:
  * RBF, Matern-3/2, Matern-5/2 kernels (isotropic lengthscale),
  * jittered Cholesky solves,
  * marginal-likelihood hyperparameter fitting via multi-start L-BFGS-B
    on (log lengthscale, log signal var, log noise var).

A copy of the reference package's module: the surrogate of
:class:`~repro_torch.core.optimizers.bayesopt.BayesOpt`, the port's only
backend.  A torch engine, when one comes, is held against it.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
from scipy.optimize import minimize

__all__ = ["GP", "rbf", "matern32", "matern52", "KERNELS"]


def _sqdist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.maximum(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1), 0.0)


def rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    return np.exp(-0.5 * _sqdist(a, b) / (ls * ls))


def matern32(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d = np.sqrt(_sqdist(a, b)) / ls
    s3 = math.sqrt(3.0)
    return (1.0 + s3 * d) * np.exp(-s3 * d)


def matern52(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d = np.sqrt(_sqdist(a, b)) / ls
    s5 = math.sqrt(5.0)
    return (1.0 + s5 * d + 5.0 / 3.0 * d * d) * np.exp(-s5 * d)


KERNELS = {"rbf": rbf, "matern32": matern32, "matern52": matern52}


class GP:
    def __init__(self, kernel: str = "matern32", noise: float = 1e-4, fit_hypers: bool = True):
        self.kernel_name = kernel
        self.kfn: Callable = KERNELS[kernel]
        self.noise = noise
        self.fit_hypers = fit_hypers
        self.ls = 0.3
        self.sv = 1.0
        self._X: Optional[np.ndarray] = None

    # ---------------------------------------------------------------- fitting
    def _nll(self, theta: np.ndarray, X: np.ndarray, y: np.ndarray,
             eye: Optional[np.ndarray] = None) -> float:
        ls, sv, nv = np.exp(theta)
        if eye is None:
            eye = np.eye(len(X))
        K = sv * self.kfn(X, X, ls) + (nv + 1e-8) * eye
        try:
            L = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            return 1e10
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
        return float(0.5 * y @ alpha + np.log(np.diag(L)).sum() + 0.5 * len(X) * math.log(2 * math.pi))

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GP":
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64).ravel()
        self._ymean, self._ystd = float(y.mean()), float(y.std() + 1e-12)
        yn = (y - self._ymean) / self._ystd
        if self.fit_hypers and len(X) >= 4:
            best, best_v = None, np.inf
            eye = np.eye(len(X))  # shared across the ~100s of nll evals
            for ls0 in (0.1, 0.3, 1.0):
                t0 = np.log([ls0, 1.0, max(self.noise, 1e-6)])
                res = minimize(
                    self._nll, t0, args=(X, yn, eye), method="L-BFGS-B",
                    bounds=[(-4.6, 2.3), (-4.6, 4.6), (-13.8, 0.0)],
                    options={"maxiter": 60},
                )
                if res.fun < best_v:
                    best, best_v = res.x, res.fun
            if best is not None:
                self.ls, self.sv, self.noise = (float(v) for v in np.exp(best))
        K = self.sv * self.kfn(X, X, self.ls) + (self.noise + 1e-8) * np.eye(len(X))
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(self._L.T, np.linalg.solve(self._L, yn))
        self._X = X
        return self

    # ------------------------------------------------------------- prediction
    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and std at query points (de-normalized)."""
        assert self._X is not None, "fit first"
        Xs = np.atleast_2d(np.asarray(Xs, dtype=np.float64))
        Ks = self.sv * self.kfn(self._X, Xs, self.ls)
        mu = Ks.T @ self._alpha
        v = np.linalg.solve(self._L, Ks)
        var = np.maximum(self.sv - (v * v).sum(0), 1e-12)
        return mu * self._ystd + self._ymean, np.sqrt(var) * self._ystd
