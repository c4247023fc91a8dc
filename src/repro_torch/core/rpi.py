"""Resource Performance Interfaces (RPI) — the SPE analogue of an API.

The port of ``repro/core/rpi.py``; envelopes persist under :data:`RPI_ROOT`
(the repository's ``results/torch/rpi/``) unless a root is given.  An RPI
declares the acceptable resource/performance *envelope* of a component
under a named workload.  Crucially (per the paper) the RPI lives in the DS
experience, NOT in system code: the same component may carry different RPIs
in different usage contexts.  RPIs ground component-level performance
regression testing — ``assert_rpi`` is used directly from pytest, and
envelopes can be *learned* from tracked runs (``RPI.learn``).
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .tracking import Tracker

__all__ = ["Bound", "RPI", "RpiReport", "assert_rpi", "RPI_ROOT"]

RPI_ROOT = Path(__file__).resolve().parents[3] / "results" / "torch" / "rpi"


@dataclass(frozen=True)
class Bound:
    metric: str
    low: float = -math.inf
    high: float = math.inf

    def check(self, value: float) -> bool:
        return self.low <= value <= self.high


@dataclass
class RpiReport:
    ok: bool
    violations: List[str] = field(default_factory=list)
    checked: int = 0

    def __bool__(self) -> bool:
        return self.ok


@dataclass
class RPI:
    component: str
    workload: str
    bounds: Tuple[Bound, ...] = ()

    def check(self, metrics: Dict[str, float]) -> RpiReport:
        violations: List[str] = []
        checked = 0
        for b in self.bounds:
            if b.metric not in metrics:
                violations.append(f"{b.metric}: missing from measurement")
                continue
            checked += 1
            v = float(metrics[b.metric])
            if not b.check(v):
                violations.append(f"{b.metric}: {v:.6g} outside [{b.low:.6g}, {b.high:.6g}]")
        return RpiReport(ok=not violations, violations=violations, checked=checked)

    # -- persistence ---------------------------------------------------------
    def save(self, root: Any = RPI_ROOT) -> Path:
        d = Path(root)
        d.mkdir(parents=True, exist_ok=True)
        p = d / f"{self.component}.{self.workload}.json"
        p.write_text(json.dumps(asdict(self), indent=1))
        return p

    @staticmethod
    def load(component: str, workload: str, root: Any = RPI_ROOT) -> "RPI":
        p = Path(root) / f"{component}.{workload}.json"
        raw = json.loads(p.read_text())
        return RPI(raw["component"], raw["workload"], tuple(Bound(**b) for b in raw["bounds"]))

    # -- learning envelopes from measured distributions ----------------------
    @staticmethod
    def from_samples(
        component: str,
        workload: str,
        metric_samples: Dict[str, Sequence[float]],
        *,
        q_low: float = 0.05,
        q_high: float = 0.95,
        slack: float = 0.25,
    ) -> "RPI":
        """Derive bounds from measured distributions: ``[q_low - slack·span,
        q_high + slack·span]`` per metric.

        Quantiles + margin, NOT observed min/max: a single outlier sample
        (one GC pause in the history) must widen the envelope by its tail
        *probability*, not by its raw magnitude.  This is the one bound
        constructor — ``learn`` (tracked runs) and baseline-store derivation
        both funnel through it.
        """
        bounds = []
        for m, vals in metric_samples.items():
            a = np.asarray(list(vals), dtype=float)
            if a.size == 0:
                continue
            lo = float(np.quantile(a, q_low))
            hi = float(np.quantile(a, q_high))
            span = max(abs(lo), abs(hi), 1e-12)
            bounds.append(Bound(m, lo - slack * span, hi + slack * span))
        return RPI(component, workload, tuple(bounds))

    @staticmethod
    def learn(
        component: str,
        workload: str,
        tracker: Tracker,
        experiment: str,
        metrics: Iterable[str],
        slack: float = 0.25,
        q_low: float = 0.05,
        q_high: float = 0.95,
    ) -> "RPI":
        """Learn an envelope from tracked runs' metric history
        (distribution quantiles + margin via :meth:`from_samples`)."""
        samples: Dict[str, List[float]] = {}
        for rec in tracker.runs(experiment):
            for m in metrics:
                hist = rec.metrics.get(m)
                if hist:
                    samples.setdefault(m, []).extend(h["value"] for h in hist)
        return RPI.from_samples(component, workload, samples,
                                q_low=q_low, q_high=q_high, slack=slack)

    @staticmethod
    def from_baseline(
        component: str,
        workload: str,
        store: Any,
        records: Iterable[Any],
        *,
        window: int = 5,
        q_low: float = 0.05,
        q_high: float = 0.95,
        slack: float = 0.25,
    ) -> "RPI":
        """Envelope from a :class:`repro_torch.core.baseline.BaselineStore`'s stored
        distributions — one bound per record coordinate, metric-named by the
        record's ``metric`` field."""
        samples = {}
        for rec in records:
            vals = store.baseline_values(rec, window=window)
            if vals:
                samples[rec.metric] = vals
        return RPI.from_samples(component, workload, samples,
                                q_low=q_low, q_high=q_high, slack=slack)


def assert_rpi(rpi: RPI, metrics: Dict[str, float]) -> None:
    rep = rpi.check(metrics)
    if not rep:
        raise AssertionError(f"RPI {rpi.component}/{rpi.workload} violated: {rep.violations}")
