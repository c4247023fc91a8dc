"""Torch-native batched GP/BO engine: the hardware-speed suggest path.

The port of ``repro/core/optimizers/engine.py``.  The numpy/scipy
:class:`~.gaussian_process.GP` refits from scratch (an O(n³) Cholesky and
3 × L-BFGS-B) on every ``ask``; this engine is the backend for the paper's
*inline* agent loop, where the optimizer rides next to the system it tunes:

  * **Rank-1 incremental Cholesky.**  ``observe`` appends one row to the
    factor in O(n²) (a masked triangular solve) instead of refactoring the
    kernel matrix.  A duplicate encoding never re-enters the factor: the
    kernel matrix depends only on X, so a collapsed categorical folds its
    best y into the existing row.
  * **Padded buffers.**  X, y and L live in fixed ``max_n`` buffers
    (power-of-two buckets, floor :data:`MIN_BUCKET`) with a row mask, so a
    program is built per bucket, never per observation.  Padded rows of L
    are identity rows and zeros elsewhere, which keeps every solve exact.
  * **Device-resident state and captured programs.**  X, y, mask, θ and L
    stay on the engine's device.  Each primitive is a step of the port's
    registry (:func:`~repro_torch.core.compilecache.cached_step`).  The
    tell and ask steps (``gp.append``, ``gp.set_y``, ``gp.suggest``) are
    bound to the engine's own static buffers through one
    :class:`~repro_torch.core.compilecache.Graphs` per engine.  The
    factor (``gp.full_chol``), the fit (``gp.fit``) and the batched suggest
    (``gp.suggest_batched``) run on buffers shared by every engine of a
    shape class, so each is built once per process, not once per engine.
    On the card each step runs as a CUDA graph per (kernel, acquisition, β,
    d, bucket, pool) class, and the bind carries that whole class, so two
    kernels or acquisitions of equal shapes never share a program;
    elsewhere its body runs eagerly on the same buffers.  A
    ``tell`` is one host→device copy and one replay; an ``ask`` uploads only
    the candidate pool and reads back the argmax and the scores in one copy.
    y-normalization, the incumbent and the live count n are derived on the
    device from the resident buffers.
  * **Multi-start hyperparameter fit.**  Projected Adam on the masked
    marginal likelihood, the three starts batched, 60 steps unrolled into
    one program.  The gradient is the closed form
    ``-½ tr((α αᵀ - K⁻¹) ∂K/∂θ)`` in log space, which is what the
    reference's ``jax.grad`` of the NLL computes, with no autograd graph to
    keep, so the fit is captured like the other steps.  Refits are
    amortized: every :attr:`TorchGP.refit_every` observations and at bucket
    growth.
  * **Fused acquisition sweep.**  EI or UCB over the whole pool (1280 rows
    in the default :class:`~.bayesopt.BayesOpt`) with its argmax, one
    program; the acquisition kind and β are constants of the program.
  * **Mux-wide batched ask.**  :class:`BatchedBayesOpt` stacks the resident
    state of same-shaped sessions into a static buffer per (signature,
    padded session count) and prices them all in one program.

Everything runs in ``torch.float64``: Cholesky at jitter 1e-8 is not
float32-safe.  A Cholesky that fails (``info > 0``) yields NaN, as the
reference's does, so the NLL reads 1e10 there and the fit's gradient 0.
The engine runs on the card unless the caller asks for the CPU; with no card
it raises.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compilecache import Graphs, cached_step

__all__ = ["TorchGP", "BatchedBayesOpt", "batched_ask", "bucket_of", "MIN_BUCKET",
           "require_device"]

DTYPE = torch.float64
MIN_BUCKET = 16          # smallest history buffer (rows)
_JITTER = 1e-8           # the numpy reference's (noise + 1e-8) diagonal
_CHUNK = 256             # the pool is padded to a multiple of this
_ADAM_STEPS = 60
_ADAM_LR = 0.08
# log-space hyper bounds (ls, sv, nv): the reference L-BFGS-B box
_THETA_LO = (-4.6, -4.6, -13.8)
_THETA_HI = (2.3, 4.6, 0.0)
_LS_STARTS = (0.1, 0.3, 1.0)
_LOG_2PI = math.log(2 * math.pi)
_INV_SQRT_2PI = 1.0 / math.sqrt(2 * math.pi)


def require_device(device: Any) -> torch.device:
    """``device``, or a RuntimeError when it is CUDA and no card is there:
    the engine never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the torch GP engine runs on the card and no CUDA device is "
                           "visible; pass device='cpu' to run it on the CPU")
    return device


def bucket_of(n: int) -> int:
    """Smallest power-of-two buffer holding ``n`` rows (floor MIN_BUCKET)."""
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    return 1 << (n - 1).bit_length()


# ------------------------------------------------------------------ kernels
# Each takes squared distances and a length scale that broadcasts against
# them, and returns (k, ∂k/∂log ls).
def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, m) squared distances between the rows of a and b."""
    return ((a.unsqueeze(-2) - b.unsqueeze(-3)) ** 2).sum(-1).clamp_min(0.0)


def _rbf(d2: torch.Tensor, ls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    r2 = d2 / (ls * ls)
    k = torch.exp(-0.5 * r2)
    return k, k * r2


_S3, _S5 = math.sqrt(3.0), math.sqrt(5.0)


def _matern32(d2: torch.Tensor, ls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    r = torch.sqrt(d2) / ls
    e = torch.exp(-_S3 * r)
    return (1.0 + _S3 * r) * e, 3.0 * r * r * e


def _matern52(d2: torch.Tensor, ls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    r = torch.sqrt(d2) / ls
    e = torch.exp(-_S5 * r)
    return (1.0 + _S5 * r + 5.0 / 3.0 * r * r) * e, 5.0 / 3.0 * r * r * (1.0 + _S5 * r) * e


_KERNELS: Dict[str, Callable] = {"rbf": _rbf, "matern32": _matern32, "matern52": _matern52}


def _ystats(yd: torch.Tensor, mask: torch.Tensor):
    """(n, ymean, ystd, yn, best) from the padded buffers, over the last
    axis: the device twin of the numpy reference's normalization."""
    n = mask.sum(-1).clamp_min(1.0)
    ymean = (yd * mask).sum(-1) / n
    ystd = torch.sqrt((((yd - ymean.unsqueeze(-1)) * mask) ** 2).sum(-1) / n) + 1e-12
    yn = (yd - ymean.unsqueeze(-1)) / ystd.unsqueeze(-1) * mask
    best = torch.where(mask > 0, yd, torch.inf).amin(-1)
    return n, ymean, ystd, yn, best


def _chol(K: torch.Tensor) -> torch.Tensor:
    """Cholesky factor, NaN where the matrix is not positive definite (the
    reference's ``jnp.linalg.cholesky``); never syncs the host."""
    L, info = torch.linalg.cholesky_ex(K, check_errors=False)
    return torch.where((info > 0).unsqueeze(-1).unsqueeze(-1), torch.nan, L)


def _alpha(L: torch.Tensor, yn: torch.Tensor) -> torch.Tensor:
    """K⁻¹ yn through the factor, over the last axis."""
    z = torch.linalg.solve_triangular(L, yn.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True).squeeze(-1)


def _kmat(d2: torch.Tensor, mask: torch.Tensor, ls, sv, nv, kfn) -> Tuple[torch.Tensor, ...]:
    """(K, sv·k·m², ∂k/∂log ls) of the masked kernel matrix; padded rows are
    identity.  ls, sv: (..., 1, 1); nv: (..., 1)."""
    k, dk = kfn(d2, ls)
    m2 = mask.unsqueeze(-1) * mask.unsqueeze(-2)
    kf = sv * k * m2
    # real diagonal = sv·k(x,x) + nv + jitter (k(x,x)=1); padded diag = 1
    K = kf + torch.diag_embed(mask * (nv + _JITTER) + (1.0 - mask))
    return K, kf, dk * m2


# -------------------------------------------------------------- step bodies
# Each writes its results into its last arguments and returns nothing, so it
# can be bound to static buffers and captured.
def _theta_parts(theta: torch.Tensor):
    """(ls, sv, nv), each (..., 1, 1), from (..., 3)."""
    t = theta.unsqueeze(-1).unsqueeze(-1)
    return t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]


def _full_chol(X, mask, theta, L_out, *, kfn) -> None:
    """The factor of the masked kernel matrix, written into ``L_out``."""
    ls, sv, nv = _theta_parts(theta)
    K, _, _ = _kmat(_sqdist(X, X), mask, ls, sv, nv.squeeze(-1), kfn)
    L_out.copy_(_chol(K))


def _append(L, X, yd, mask, staged, theta, *, kfn) -> None:
    """One tell: write row n (x = staged[:d], y = staged[d]) into X, y and
    the mask, and extend the factor by its rank-1 row (an O(n²) masked
    triangular solve).  n is read from the mask on the device."""
    ls, sv, nv = theta[0], theta[1], theta[2]
    d = X.shape[-1]
    x_new, y_new = staged[:d], staged[d:]
    n = mask.sum().long().view(1)
    k_vec = sv * kfn(_sqdist(X, x_new.unsqueeze(0)), ls)[0][:, 0] * mask
    l = torch.linalg.solve_triangular(L, k_vec.unsqueeze(-1), upper=False).squeeze(-1)
    l_ss = torch.sqrt(torch.clamp_min(sv + nv + _JITTER - l @ l, 1e-12))
    idx = torch.arange(L.shape[0], device=L.device)
    row = torch.where(idx < n, l, 0.0)
    row = torch.where(idx == n, l_ss, row)
    L.index_copy_(0, n, row.unsqueeze(0))
    X.index_copy_(0, n, x_new.unsqueeze(0))
    yd.index_copy_(0, n, y_new)
    mask.index_fill_(0, n, 1.0)


def _set_y(yd, staged) -> None:
    """Duplicate-encoding fold: K (and L) depend only on X, so only the
    observed value changes.  staged = (row, value)."""
    yd.index_copy_(0, staged[:1].long(), staged[1:])


def _nll(th, d2, mask, yn, n, kfn, grad: bool):
    """Masked negative log marginal likelihood of each start (R, 3) in log
    space (padded rows contribute 0), NaN → 1e10; with ``grad`` also its
    closed-form gradient -½ tr((α αᵀ - K⁻¹) ∂K/∂θ), NaN → 0."""
    t = torch.exp(th)
    ls, sv, nv = t[:, 0, None, None], t[:, 1, None, None], t[:, 2, None]
    K, kf, dk = _kmat(d2, mask, ls, sv, nv, kfn)
    L = _chol(K)
    alpha = _alpha(L, yn.expand(L.shape[:-1]))
    logdet = torch.log(torch.clamp_min(torch.diagonal(L, dim1=-2, dim2=-1), 1e-300)).sum(-1)
    v = 0.5 * (yn * alpha).sum(-1) + logdet + 0.5 * n * _LOG_2PI
    v = torch.where(torch.isnan(v), 1e10, v)
    if not grad:
        return v, None
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    linv = torch.linalg.solve_triangular(L, eye, upper=False)
    W = alpha.unsqueeze(-1) * alpha.unsqueeze(-2) - linv.mT @ linv
    g = -0.5 * torch.stack([(W * (sv * dk)).sum((-2, -1)), (W * kf).sum((-2, -1)),
                            (torch.diagonal(W, dim1=-2, dim2=-1) * mask * nv).sum(-1)], -1)
    return v, torch.where(torch.isnan(g), 0.0, g)


def _fit_hypers(X, mask, yd, theta0s, theta_out, *, kfn) -> None:
    """Projected multi-start Adam on the NLL (starts batched), the best
    start's θ written into ``theta_out``."""
    n, _, _, yn, _ = _ystats(yd, mask)
    d2 = _sqdist(X, X)
    th = theta0s.clone()
    m = torch.zeros_like(th)
    v = torch.zeros_like(th)
    for t in range(1, _ADAM_STEPS + 1):
        _, g = _nll(th, d2, mask, yn, n, kfn, grad=True)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1.0 - 0.9 ** t)
        vhat = v / (1.0 - 0.999 ** t)
        th = th - _ADAM_LR * mhat / (torch.sqrt(vhat) + 1e-8)
        th = torch.stack([th[:, i].clamp(_THETA_LO[i], _THETA_HI[i]) for i in range(3)], -1)
    vals, _ = _nll(th, d2, mask, yn, n, kfn, grad=False)
    theta_out.copy_(torch.exp(th.index_select(0, torch.argmin(vals).view(1))[0]))


def _suggest(L, X, mask, yd, theta, cand, out, *, kfn, acq_id: int, beta: float) -> None:
    """Posterior, acquisition and argmax over the pool, over any leading
    session axes: ``out[..., 0]`` = the argmax, ``out[..., 1:]`` = the
    scores."""
    ls, sv, _ = _theta_parts(theta)
    _, ymean, ystd, yn, best = _ystats(yd, mask)
    alpha = _alpha(L, yn)
    Ks = sv * kfn(_sqdist(X, cand), ls)[0] * mask.unsqueeze(-1)          # (..., n, P)
    mu = (Ks.mT @ alpha.unsqueeze(-1)).squeeze(-1)
    w = torch.linalg.solve_triangular(L, Ks, upper=False)
    var = torch.clamp_min(sv[..., 0] - (w * w).sum(-2), 1e-12)
    mu_d = mu * ystd.unsqueeze(-1) + ymean.unsqueeze(-1)
    sd_d = torch.sqrt(var) * ystd.unsqueeze(-1)
    if acq_id == 1:  # lower-confidence bound for minimization
        s = -(mu_d - beta * sd_d)
    else:
        imp = best.unsqueeze(-1) - mu_d
        z = imp / torch.clamp_min(sd_d, 1e-12)
        ei = imp * torch.special.ndtr(z) + sd_d * torch.exp(-0.5 * z * z) * _INV_SQRT_2PI
        s = torch.where(sd_d > 1e-12, ei, 0.0)
    out[..., 0] = torch.argmax(s, dim=-1).to(out.dtype)
    out[..., 1:] = s


@functools.lru_cache(maxsize=None)
def _body(name: str, kernel: str, acq_id: int = 0, beta: float = 0.0) -> Callable:
    kfn = _KERNELS[kernel]
    if name == "gp.suggest":
        return functools.partial(_suggest, kfn=kfn, acq_id=acq_id, beta=beta)
    return {"gp.full_chol": functools.partial(_full_chol, kfn=kfn),
            "gp.append": functools.partial(_append, kfn=kfn),
            "gp.fit": functools.partial(_fit_hypers, kfn=kfn),
            "gp.set_y": _set_y}[name]


def _step(name: str, kernel: str, shape: Tuple, acq_id: int = 0, beta: float = 0.0):
    """The registry's step for one primitive and shape class."""
    return cached_step(_body(name, kernel, acq_id, beta), key=name,
                       context=(kernel, acq_id, beta) + tuple(shape))


def _pad_pool(cand: np.ndarray) -> np.ndarray:
    """Pad the candidate pool to a _CHUNK multiple (duplicates of the last
    row: argmax returns the first occurrence, so padding can't win)."""
    rem = -len(cand) % _CHUNK
    if rem:
        cand = np.concatenate([cand, np.repeat(cand[-1:], rem, axis=0)])
    return cand


def _acq_id(acq: str) -> int:
    return 1 if acq == "ucb" else 0


# ------------------------------------------------------------------- engine
class TorchGP:
    """Incremental, bucket-padded GP surrogate for one optimizer.

    ``observe`` is one staged copy and one replay of the rank-1 append
    (duplicate rows fold in place); ``suggest`` uploads only the candidate
    pool.  Hyperparameters refit on a cadence (``refit_every``
    observations, and whenever the buffer grows a bucket), with the factor
    rebuilt once per refit.  Host numpy mirrors of X/y are kept for
    candidate generation, de-duplication and tests; they never ride the
    dispatch path.
    """

    def __init__(self, d: int, kernel: str = "matern32", noise: float = 1e-4,
                 fit_hypers: bool = True, refit_every: int = 8, device: Any = "cuda"):
        if kernel not in _KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}")
        self.device = require_device(device)
        self.d = d
        self.kernel = kernel
        self.fit_hypers = fit_hypers
        self.refit_every = refit_every
        self.max_n = MIN_BUCKET
        self.n = 0
        self._Xb = np.zeros((self.max_n, d), dtype=np.float64)
        self._yb = np.zeros(self.max_n, dtype=np.float64)
        self._index: Dict[bytes, int] = {}  # encoded-row bytes -> buffer row
        # (ls, sv, nv): the numpy reference's defaults
        self.theta = np.array([0.3, 1.0, noise], dtype=np.float64)
        self._tells_since_refit = 0
        self._hypers_fresh = not fit_hypers
        self.refactorizations = 0  # full factor builds, for tests
        self.graphs = Graphs(capture=self.device.type == "cuda")
        self._buf: Dict[str, torch.Tensor] = {}   # the current bucket's device buffers
        self._staged: Dict[str, torch.Tensor] = {}
        self._pools: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._bound: Dict[Tuple, Any] = {}
        self._resident = False   # the device buffers hold the host state
        self._factored = False   # and L is their factor

    # -- views ---------------------------------------------------------------
    @property
    def X(self) -> np.ndarray:
        return self._Xb[: self.n]

    @property
    def y(self) -> np.ndarray:
        return self._yb[: self.n]

    @property
    def L(self) -> Optional[torch.Tensor]:
        """The resident factor (padded), or None when it is not built."""
        return self._buf["L"] if self._factored else None

    def state(self) -> Tuple[torch.Tensor, ...]:
        """(L, X, mask, y, θ) on the device; call ensure_ready first."""
        b = self._buf
        return b["L"], b["X"], b["mask"], b["y"], b["theta"]

    def incumbent(self) -> np.ndarray:
        return self.X[int(np.argmin(self.y))]

    def _new(self, *shape: int) -> torch.Tensor:
        return torch.zeros(shape, dtype=DTYPE, device=self.device)

    def _run(self, name: str, args: Tuple, pool: int = 0, acq_id: int = 0,
             beta: float = 0.0) -> None:
        """Run the primitive's step bound to ``args`` (bound once per shape
        class: a bucket, and for the suggest a pool size and acquisition)."""
        key = (name, self.max_n, pool, acq_id, beta)
        bound = self._bound.get(key)
        if bound is None:
            shape = (self.d, self.max_n) + ((pool,) if pool else ())
            step = _step(name, self.kernel, shape, acq_id, beta)
            bound = self._bound[key] = self.graphs.bind(name, step, *args, variant=step.context)
        bound()

    def _stage(self, name: str, values: np.ndarray) -> torch.Tensor:
        buf = self._staged.get(name)
        if buf is None:
            buf = self._staged[name] = self._new(*values.shape)
        buf.copy_(torch.from_numpy(values))
        return buf

    # -- ingest --------------------------------------------------------------
    def observe(self, x: np.ndarray, y: float) -> None:
        """Fold one (encoded config, value) pair into the surrogate state."""
        x = np.ascontiguousarray(np.asarray(x, dtype=np.float64))
        y = float(y)
        key = x.tobytes()
        row = self._index.get(key)
        if row is not None:
            # Duplicate encoding: keep the best observation for this row.
            val = min(self._yb[row], y)
            self._yb[row] = val
            if self._factored:
                staged = self._stage("set_y", np.array([row, val], dtype=np.float64))
                self._run("gp.set_y", (self._buf["y"], staged))
            return
        if self.n == self.max_n:
            self._grow()
        i = self.n
        self._Xb[i] = x
        self._yb[i] = y
        self._index[key] = i
        if self._factored:
            b = self._buf
            staged = self._stage("append", np.append(x, y))
            self._run("gp.append", (b["L"], b["X"], b["y"], b["mask"], staged, b["theta"]))
        self.n = i + 1
        self._tells_since_refit += 1
        if self.fit_hypers and self._tells_since_refit >= self.refit_every:
            self._hypers_fresh = False

    def seed_observations(self, X: np.ndarray, y: np.ndarray) -> int:
        """Bulk-inject prior (encoded config, value) pairs: the warm-start path.

        The rows land straight in the padded host buffers (growing the
        bucket once, to fit them all) and the resident state is invalidated,
        so the next ``ensure_ready`` uploads and refactors exactly once.
        Duplicate encodings fold keep-best, as in ``observe``.  Returns the
        number of *new* rows.
        """
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        if X.shape[0] != y.shape[0] or X.shape[1] != self.d:
            raise ValueError(f"seed_observations: shapes {X.shape}/{y.shape} "
                             f"do not match d={self.d}")
        added = 0
        changed = False
        for xi, yi in zip(X, y):
            xi = np.ascontiguousarray(xi)
            key = xi.tobytes()
            row = self._index.get(key)
            if row is not None:
                if float(yi) < self._yb[row]:
                    self._yb[row] = float(yi)
                    changed = True  # host y moved: the resident y is stale
                continue
            while self.n + 1 > self.max_n:
                self._grow()
            self._Xb[self.n] = xi
            self._yb[self.n] = float(yi)
            self._index[key] = self.n
            self.n += 1
            added += 1
        if added or changed:
            self._resident = self._factored = False
            if self.fit_hypers:
                self._hypers_fresh = False
        return added

    def _grow(self) -> None:
        self.max_n *= 2
        Xb = np.zeros((self.max_n, self.d), dtype=np.float64)
        yb = np.zeros(self.max_n, dtype=np.float64)
        Xb[: self.n] = self._Xb
        yb[: self.n] = self._yb
        self._Xb, self._yb = Xb, yb
        self._resident = self._factored = False  # new buffers at the new bucket
        if self.fit_hypers:
            self._hypers_fresh = False

    # -- fitting -------------------------------------------------------------
    def _upload(self) -> None:
        """Copy the host state into the bucket's static buffers (allocated
        once per bucket: the programs bound to them stay valid)."""
        b = self._buf
        if "X" not in b or b["X"].shape[0] != self.max_n:
            n = self.max_n
            self._buf = b = {"X": self._new(n, self.d), "y": self._new(n), "mask": self._new(n),
                             "theta": self._new(3), "L": self._new(n, n)}
        mask = np.zeros(self.max_n, dtype=np.float64)
        mask[: self.n] = 1.0
        for name, host in (("X", self._Xb), ("y", self._yb), ("mask", mask),
                           ("theta", self.theta)):
            b[name].copy_(torch.from_numpy(host))
        self._resident = True

    def ensure_ready(self) -> None:
        """Refit hypers if due, rebuild the factor if missing (one program
        each, amortized across many observes)."""
        if self.n == 0:
            raise RuntimeError("observe() first")
        if not self._resident:
            self._upload()
        b = self._buf
        if self.fit_hypers and not self._hypers_fresh and self.n >= 4:
            theta0s = np.log([[ls0, 1.0, max(self.theta[2], 1e-6)] for ls0 in _LS_STARTS])
            theta, = _shared_run(self, "gp.fit", (b["X"], b["mask"], b["y"],
                                                  torch.from_numpy(theta0s)), [(3,)])
            b["theta"].copy_(theta)
            self.theta = theta.cpu().numpy().copy()
            self._hypers_fresh = True
            self._tells_since_refit = 0
            self._factored = False
        if not self._factored:
            L, = _shared_run(self, "gp.full_chol", (b["X"], b["mask"], b["theta"]),
                             [(self.max_n, self.max_n)])
            b["L"].copy_(L)
            self._factored = True
            self.refactorizations += 1

    # -- suggest -------------------------------------------------------------
    def _pool(self, padded: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """The static pool and output buffers for this pool size."""
        bufs = self._pools.get(len(padded))
        if bufs is None:
            bufs = self._pools[len(padded)] = (self._new(len(padded), self.d),
                                               self._new(len(padded) + 1))
        return bufs

    def _suggest_padded(self, padded: np.ndarray, acq_id: int,
                        beta: float) -> Tuple[int, np.ndarray]:
        cand, out = self._pool(padded)
        cand.copy_(torch.from_numpy(np.ascontiguousarray(padded)))
        self._run("gp.suggest", self.state() + (cand, out), len(padded), acq_id, float(beta))
        host = out.cpu().numpy()
        return int(host[0]), host[1:]

    def suggest(self, cand: np.ndarray, acq: str = "ei",
                ucb_beta: float = 2.0) -> Tuple[int, np.ndarray]:
        """Score the pool, return (argmax index, scores[:len(cand)])."""
        self.ensure_ready()
        idx, scores = self._suggest_padded(_pad_pool(np.asarray(cand, dtype=np.float64)),
                                           _acq_id(acq), ucb_beta)
        return idx, scores[: len(cand)]


# ------------------------------------------------- programs shared by engines
# The factor, the fit (60 unrolled Adam steps) and the batched suggest run on
# static buffers of their own, one set per shape class and process: every
# engine of that class copies its state in and replays the same program, so a
# campaign of many sessions captures each once, not once per session.
_SHARED_GRAPHS: Dict[torch.device, Graphs] = {}
_SHARED_BUFFERS: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def _shared(key: str, context: Tuple, device: torch.device, shapes: Sequence[Tuple[int, ...]],
            body: Callable) -> Tuple[Tuple[torch.Tensor, ...], Any]:
    """(buffers, bound step) of one shared program and shape class."""
    bufs = _SHARED_BUFFERS.get((key, context, device))
    if bufs is None:
        bufs = _SHARED_BUFFERS[(key, context, device)] = tuple(
            torch.zeros(shape, dtype=DTYPE, device=device) for shape in shapes)
    graphs = _SHARED_GRAPHS.get(device)
    if graphs is None:
        graphs = _SHARED_GRAPHS[device] = Graphs(capture=device.type == "cuda")
    return bufs, graphs.bind(key, cached_step(body, key=key, context=context), *bufs,
                             variant=context)


def _shared_run(eng: "TorchGP", key: str, inputs: Sequence[torch.Tensor],
                out_shapes: Sequence[Tuple[int, ...]]) -> Tuple[torch.Tensor, ...]:
    """Run the shared program ``key`` of the engine's (kernel, d, bucket):
    copy ``inputs`` into its buffers, replay, and return its output buffers
    (valid until the next run of that program)."""
    bufs, step = _shared(key, (eng.kernel, eng.d, eng.max_n), eng.device,
                         [tuple(x.shape) for x in inputs] + list(out_shapes),
                         _body(key, eng.kernel))
    for buf, src in zip(bufs, inputs):
        buf.copy_(src)
    step()
    return bufs[len(inputs):]


# ------------------------------------------------------------- batched asks
def _torch_model_ready(opt: Any) -> bool:
    """True when ``opt`` is a torch-backed BayesOpt past its init phase
    (duck-typed to avoid an import cycle with bayesopt.py)."""
    return getattr(opt, "backend", None) == "torch" and opt.model_ready


def _batched_indices(sig: Tuple, members: List[Tuple]) -> np.ndarray:
    """One program for the whole group: the members' resident state stacked
    into the group's static buffers (the session axis padded to a power of
    two by repeating the last member, so a mux whose ready count varies
    builds log2(N) programs per signature, not N), and the S argmax indices
    read back in one copy."""
    kernel, acq_id, beta, d, n, pool, device = sig
    S = len(members)
    P = 1 << (S - 1).bit_length()
    bufs, step = _shared("gp.suggest_batched", (kernel, acq_id, beta, d, n, pool, P), device,
                         [(P, n, n), (P, n, d), (P, n), (P, n), (P, 3), (P, pool, d),
                          (P, pool + 1)], _body("gp.suggest", kernel, acq_id, beta))
    states = [m[1].state() for m in members]
    states += [states[-1]] * (P - S)
    for j, buf in enumerate(bufs[:5]):
        torch.stack([s[j] for s in states], out=buf)
    pools = [m[2] for m in members]
    bufs[5].copy_(torch.from_numpy(np.stack(pools + [pools[-1]] * (P - S))))
    step()
    return bufs[6][:, 0].cpu().numpy()[:S]


class BatchedBayesOpt:
    """One program for N sessions' suggestions.

    Groups torch-backed :class:`~.bayesopt.BayesOpt` optimizers by
    signature (kernel, acquisition, β, d, bucket, pool, device), stacks
    their resident state along a session axis and runs the batched suggest
    once per group.  Optimizers that are still in their init phase (or are
    not torch BO at all) use their own ``ask``: the result is element-wise
    identical to sequential asks.
    """

    def __init__(self, opts: Sequence[Any]):
        self.opts = list(opts)

    def ask_all(self) -> List[Dict[str, Any]]:
        out: List[Optional[Dict[str, Any]]] = [None] * len(self.opts)
        groups: Dict[Tuple, List[Tuple[int, Any, np.ndarray]]] = {}
        for i, opt in enumerate(self.opts):
            if not _torch_model_ready(opt):
                out[i] = opt.ask()
                continue
            eng, cand, acq_id, beta = opt._model_inputs()
            eng.ensure_ready()
            cand = _pad_pool(cand)
            sig = (eng.kernel, acq_id, float(beta), eng.d, eng.max_n, len(cand), eng.device)
            groups.setdefault(sig, []).append((i, eng, cand))
        for sig, members in groups.items():
            if len(members) == 1:
                _, eng, cand = members[0]
                idxs = [eng._suggest_padded(cand, sig[1], sig[2])[0]]
            else:
                idxs = _batched_indices(sig, members)
            for (i, _, cand), idx in zip(members, idxs):
                opt = self.opts[i]
                out[i] = opt.space.validate(opt.space.decode(cand[int(idx)]))
        return out  # type: ignore[return-value]


def batched_ask(opts: Sequence[Any]) -> List[Dict[str, Any]]:
    """Convenience: one-shot :class:`BatchedBayesOpt` over ``opts``."""
    return BatchedBayesOpt(opts).ask_all()
