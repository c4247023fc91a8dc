"""Noise-aware measurement statistics — the repo's one source of perf truth.

MLOS's promise is *continuous, robust, trackable* optimization; that promise
dies the moment a keep/revert decision is taken on a single noisy number
against a raw percentage threshold.  This module is the measurement
discipline every perf claim routes through:

  * **Robust location/spread** — :func:`median`, :func:`mad`,
    :func:`trimmed_mean`: wall-clock samples are heavy-tailed (GC pauses,
    recompiles, CPU migration), so means and stddevs lie.
  * **Adaptive repetition** — :func:`measure_adaptive` keeps sampling until
    the bootstrap confidence interval of the median is narrower than a
    target relative width, or the rep/wall budget is exhausted — fast runs
    stop early, noisy runs buy precision with repetitions.
  * **A/B comparison** — :func:`compare` takes two sample sets and returns a
    three-way :class:`Comparison` verdict ``improved | regressed | noise``:
    a seeded permutation test on the difference of medians supplies the
    p-value, the relative median shift supplies the effect size, and a
    verdict is only non-noise when the shift is both statistically
    significant and larger than ``min_effect``.  With singleton samples
    (analytic estimates, one-shot timings) the test degrades gracefully to
    an effect-size-only decision — same API, weaker evidence.
  * **Interleaved measurement** — :func:`measure_interleaved` alternates
    A/B/A/B calls so slow drift (thermal, frequency scaling) cancels out of
    the comparison instead of masquerading as a regression.

Everything randomized is seeded and deterministic: the same samples always
produce the same verdict, so CI gate decisions are reproducible.

A copy of the reference package's module (numpy only), kept here so the
port imports nothing of it.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Measurement", "Comparison", "StreamingAB",
    "median", "mad", "trimmed_mean", "bootstrap_ci",
    "measure_adaptive", "measure_interleaved", "compare",
]

# Normal-consistency constant: MAD * 1.4826 estimates sigma for Gaussian data.
_MAD_SCALE = 1.4826


def median(values: Sequence[float]) -> float:
    return float(np.median(np.asarray(values, dtype=float)))


def mad(values: Sequence[float], scale: float = _MAD_SCALE) -> float:
    """Median absolute deviation (sigma-consistent by default)."""
    a = np.asarray(values, dtype=float)
    return float(scale * np.median(np.abs(a - np.median(a))))


def trimmed_mean(values: Sequence[float], trim: float = 0.1) -> float:
    """Mean of the central ``1 - 2*trim`` mass — robust to a few outliers
    while using more of the sample than the median."""
    a = np.sort(np.asarray(values, dtype=float))
    k = int(len(a) * trim)
    core = a[k:len(a) - k] if len(a) > 2 * k else a
    return float(core.mean())


def bootstrap_ci(values: Sequence[float], *, confidence: float = 0.95,
                 n_boot: int = 400, stat: Callable[[np.ndarray], float] = np.median,
                 seed: int = 0) -> Tuple[float, float]:
    """Percentile-bootstrap CI of ``stat`` (default: the median).

    Deterministic under ``seed``; a singleton sample returns a degenerate
    zero-width interval rather than raising.
    """
    a = np.asarray(values, dtype=float)
    if a.size == 0:
        raise ValueError("bootstrap_ci of an empty sample")
    if a.size == 1:
        return float(a[0]), float(a[0])
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, a.size, size=(n_boot, a.size))
    if stat is np.median:  # the default — vectorized; this sits on
        stats = np.median(a[idx], axis=1)  # measure_adaptive's per-rep path
    else:
        stats = np.apply_along_axis(stat, 1, a[idx])
    lo = (1.0 - confidence) / 2.0
    return (float(np.quantile(stats, lo)), float(np.quantile(stats, 1.0 - lo)))


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One metric measured to (attempted) target precision."""

    values: Tuple[float, ...]
    location: float          # robust location: median of values
    spread: float            # MAD (sigma-consistent)
    ci_low: float            # bootstrap CI of the median
    ci_high: float
    reps: int
    converged: bool          # CI narrowed below target before budget ran out

    @property
    def rel_ci_width(self) -> float:
        denom = max(abs(self.location), 1e-12)
        return (self.ci_high - self.ci_low) / denom

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["values"] = list(self.values)
        return d


def measure_adaptive(fn: Callable[[], float], *, target_rel_ci: float = 0.10,
                     min_reps: int = 5, max_reps: int = 64,
                     budget_s: Optional[float] = None,
                     confidence: float = 0.95, seed: int = 0) -> Measurement:
    """Call ``fn`` until the bootstrap CI of the median is narrower than
    ``target_rel_ci`` (relative to the median) or the budget is exhausted.

    Budgets are hard caps: at most ``max_reps`` calls, and no *new* call
    starts once ``budget_s`` wall-seconds have elapsed (at least ``min_reps``
    calls always run so there is something to summarize).
    """
    if min_reps < 1 or max_reps < min_reps:
        raise ValueError(f"bad rep bounds: min={min_reps} max={max_reps}")
    t0 = time.perf_counter()
    values: List[float] = []
    converged = False
    while len(values) < max_reps:
        if len(values) >= min_reps:
            lo, hi = bootstrap_ci(values, confidence=confidence, seed=seed)
            loc = median(values)
            if (hi - lo) / max(abs(loc), 1e-12) <= target_rel_ci:
                converged = True
                break
            if budget_s is not None and time.perf_counter() - t0 >= budget_s:
                break
        values.append(float(fn()))
    lo, hi = bootstrap_ci(values, confidence=confidence, seed=seed)
    return Measurement(values=tuple(values), location=median(values),
                       spread=mad(values), ci_low=lo, ci_high=hi,
                       reps=len(values), converged=converged)


def measure_interleaved(fn_a: Callable[[], float], fn_b: Callable[[], float],
                        reps: int = 9, warmup: int = 1) -> Tuple[List[float], List[float]]:
    """Interleave A/B/A/B measurements so slow environmental drift lands in
    both samples instead of biasing one side of the comparison."""
    for _ in range(max(warmup, 0)):
        fn_a(), fn_b()
    a: List[float] = []
    b: List[float] = []
    for _ in range(max(reps, 1)):
        a.append(float(fn_a()))
        b.append(float(fn_b()))
    return a, b


@dataclasses.dataclass(frozen=True)
class Comparison:
    """Outcome of an A/B comparison; the verdict is the contract.

    ``effect`` is the relative shift of the candidate's location versus the
    baseline's ((cand - base) / |base|) — positive means the candidate's
    metric is larger.  Under ``mode="min"`` (latencies: lower is better) a
    significant positive effect reads ``regressed``; under ``mode="max"``
    (throughputs) the reading flips.
    """

    verdict: str                   # "improved" | "regressed" | "noise"
    effect: float
    p_value: Optional[float]       # None when a test was not meaningful
    significant: bool
    baseline_location: float
    candidate_location: float
    baseline_n: int
    candidate_n: int
    alpha: float
    min_effect: float

    @property
    def ok(self) -> bool:
        return self.verdict != "regressed"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        p = "n/a" if self.p_value is None else f"{self.p_value:.4f}"
        return (f"{self.verdict} (effect {self.effect:+.1%}, p={p}, "
                f"n={self.baseline_n}v{self.candidate_n})")


def _perm_pvalue(a: np.ndarray, b: np.ndarray, n_perm: int, seed: int) -> float:
    """Two-sided permutation test on the difference of medians.

    The label permutation is the exact null for "same distribution"; medians
    keep the statistic robust to the tails that plague wall-clock samples.
    """
    observed = abs(np.median(b) - np.median(a))
    pooled = np.concatenate([a, b])
    rng = np.random.default_rng(seed)
    hits = 1  # add-one smoothing: p is never exactly 0, test stays valid
    for _ in range(n_perm):
        perm = rng.permutation(pooled)
        d = abs(np.median(perm[a.size:]) - np.median(perm[:a.size]))
        if d >= observed - 1e-15:
            hits += 1
    return hits / (n_perm + 1)


def compare(baseline: Sequence[float], candidate: Sequence[float], *,
            alpha: float = 0.05, min_effect: float = 0.05, mode: str = "min",
            n_perm: int = 1000, seed: int = 0) -> Comparison:
    """Three-way A/B verdict: ``improved``, ``regressed``, or ``noise``.

    A verdict is only non-noise when the median shift clears ``min_effect``
    AND the permutation test rejects "same distribution" at ``alpha``.  When
    either side has fewer than 2 samples — or is so small the test cannot
    possibly reach ``alpha`` — no p-value is computed and the decision falls
    back to effect size alone (singleton analytic estimates still get a
    verdict, just without statistical cover).  Deterministic under ``seed``.
    """
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    a = np.asarray(baseline, dtype=float)
    b = np.asarray(candidate, dtype=float)
    if a.size == 0 or b.size == 0:
        raise ValueError("compare() needs at least one sample per side")
    loc_a, loc_b = float(np.median(a)), float(np.median(b))
    effect = (loc_b - loc_a) / max(abs(loc_a), 1e-12)

    p_value: Optional[float] = None
    if min(a.size, b.size) >= 2:
        # Smallest achievable p for a label permutation: if even that cannot
        # clear alpha, the test is uninformative — fall back to effect size.
        min_p = 1.0 / (math.comb(a.size + b.size, a.size))
        if min_p <= alpha:
            p_value = _perm_pvalue(a, b, n_perm=n_perm, seed=seed)

    big_enough = abs(effect) >= min_effect
    significant = big_enough and (p_value is None or p_value <= alpha)
    if not significant:
        verdict = "noise"
    else:
        worse = effect > 0 if mode == "min" else effect < 0
        verdict = "regressed" if worse else "improved"
    return Comparison(verdict=verdict, effect=effect, p_value=p_value,
                      significant=significant, baseline_location=loc_a,
                      candidate_location=loc_b, baseline_n=int(a.size),
                      candidate_n=int(b.size), alpha=alpha, min_effect=min_effect)


class StreamingAB:
    """Sequential interleaved A/B verdict over *streaming* measurement windows.

    The online-tuning shape of :func:`measure_interleaved` + :func:`compare`:
    samples arrive one interleaved (baseline, candidate) pair at a time — e.g.
    alternating champion/challenger serve windows — and the caller wants a
    decision as early as the evidence allows.  :meth:`add_pair` accumulates a
    pair and returns the verdict over everything seen so far; :attr:`decided`
    goes True when the canary can stop:

      * ``regressed`` decides IMMEDIATELY — rollback is cheap and safe, so one
        clear regression window is enough to pull a canary (fail-fast).  With
        a single pair :func:`compare` falls back to effect size only, which is
        exactly the conservative reading we want.
      * ``improved`` needs at least ``min_pairs`` pairs — promotion is durable,
        so it must not ride on a lucky window.
      * ``max_pairs`` caps the canary: once reached, whatever :meth:`verdict`
        says is final (typically ``noise`` → keep the champion).

    Deterministic under ``seed`` like everything else in this module.
    """

    def __init__(self, *, mode: str = "max", alpha: float = 0.05,
                 min_effect: float = 0.05, min_pairs: int = 3,
                 max_pairs: int = 8, seed: int = 0):
        if min_pairs < 1 or max_pairs < min_pairs:
            raise ValueError(f"bad pair bounds: min={min_pairs} max={max_pairs}")
        self.mode = mode
        self.alpha = alpha
        self.min_effect = min_effect
        self.min_pairs = min_pairs
        self.max_pairs = max_pairs
        self.seed = seed
        self.baseline: List[float] = []
        self.candidate: List[float] = []

    @property
    def pairs(self) -> int:
        return len(self.candidate)

    def add_pair(self, baseline_sample: float, candidate_sample: float) -> Comparison:
        """Accumulate one interleaved window pair; return the running verdict."""
        self.baseline.append(float(baseline_sample))
        self.candidate.append(float(candidate_sample))
        return self.verdict()

    def verdict(self) -> Comparison:
        if not self.candidate:
            raise ValueError("StreamingAB verdict before any pair was added")
        return compare(self.baseline, self.candidate, alpha=self.alpha,
                       min_effect=self.min_effect, mode=self.mode, seed=self.seed)

    @property
    def decided(self) -> bool:
        if not self.candidate:
            return False
        if self.pairs >= self.max_pairs:
            return True
        v = self.verdict().verdict
        if v == "regressed":
            return True
        return v == "improved" and self.pairs >= self.min_pairs
