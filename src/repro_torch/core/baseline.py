"""Persistent perf baselines: every benchmark run becomes a trajectory point.

The port of ``repro/core/baseline.py``.  Every benchmark record is
*appended* to a schema-versioned trajectory (by default
:data:`TRAJECTORY_PATH`, the repository's
``results/torch/bench/trajectory.jsonl``, apart from the reference's),
keyed by its context (component × workload × hardware fingerprint ×
software version, from :mod:`repro_torch.core.configstore`, so a record
taken on the CPU never matches one taken on the card) plus provenance (git
sha, timestamp, quick/full flag) — and the stored history doubles as the
**baseline distribution** the next run is gated against:

    store = BaselineStore()
    store.append(records)                  # this run becomes history
    report = store.check(record)           # verdict vs pooled recent history

``check`` pools the last ``window`` matching runs (same benchmark, metric,
context and quick-flag) and routes the decision through
:func:`repro_torch.core.stats.compare`: ``regressed`` only when the shift is
statistically significant AND beyond tolerance, ``noise`` for run-to-run
jitter.  No matching history reads ``no_baseline`` and passes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence

from . import stats
from .configstore import Context, hardware_fingerprint, sw_fingerprint

__all__ = ["SCHEMA_VERSION", "BenchRecord", "GateReport", "BaselineStore", "git_sha",
           "REPO_ROOT", "TRAJECTORY_PATH"]

SCHEMA_VERSION = 1
REPO_ROOT = Path(__file__).resolve().parents[3]
TRAJECTORY_PATH = REPO_ROOT / "results" / "torch" / "bench" / "trajectory.jsonl"


def git_sha(root: Any = None) -> Optional[str]:
    """The commit sha of the checkout whose top level is ``root`` (by
    default the one this package lies in), or None when ``root`` is not the
    top of a checkout: a ``git archive`` has no commit of its own, even
    unpacked inside another checkout, and the enclosing tree's sha would be
    a false provenance.  Provenance must never fail a benchmark run."""
    root = Path(root if root is not None else REPO_ROOT).resolve()
    try:
        r = subprocess.run(["git", "rev-parse", "--show-toplevel", "HEAD"], capture_output=True,
                           text=True, timeout=10, cwd=root)
    except (OSError, subprocess.SubprocessError):
        return None
    out = r.stdout.split()
    if r.returncode != 0 or len(out) != 2 or Path(out[0]).resolve() != root:
        return None
    return out[1]


@dataclasses.dataclass(frozen=True)
class BenchRecord:
    """One measured metric of one benchmark under one context."""

    benchmark: str                  # e.g. "optimizer_throughput"
    metric: str                     # e.g. "ask_ms/jax/n25"
    values: Sequence[float]         # raw samples (never pre-aggregated)
    context: Context                # component × workload × hw × sw
    mode: str = "min"               # "min": lower is better; "max": higher
    unit: str = ""
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def for_component(benchmark: str, metric: str, values: Sequence[float],
                      component: str, workload: str, *, mode: str = "min",
                      unit: str = "", **meta: Any) -> "BenchRecord":
        """Record under *this* process's hardware/software coordinates."""
        ctx = Context(component, workload, hardware_fingerprint(), sw_fingerprint())
        return BenchRecord(benchmark, metric, [float(v) for v in values], ctx,
                           mode=mode, unit=unit, meta=dict(meta))


@dataclasses.dataclass(frozen=True)
class GateReport:
    """Verdict of one record against its stored baseline distribution.

    ``verdict`` extends the comparator's three-way contract with two
    gate-specific passes: ``no_baseline`` (no stored history yet) and
    ``insufficient_data`` (the shift cleared tolerance but the samples are
    too few for the permutation test to ever reach significance — a CI gate
    must not fail on evidence-free jitter)."""

    benchmark: str
    metric: str
    verdict: str       # improved | regressed | noise | no_baseline | insufficient_data
    comparison: Optional[stats.Comparison]
    baseline_runs: int                 # how many stored runs were pooled
    baseline_n: int                    # how many samples they contributed

    @property
    def ok(self) -> bool:
        return self.verdict != "regressed"

    def describe(self) -> str:
        detail = self.comparison.describe() if self.comparison else \
            f"no stored history ({self.baseline_runs} runs)"
        if self.comparison is not None and self.verdict != self.comparison.verdict:
            detail = f"{self.verdict} [{detail}]"
        return f"{self.benchmark}:{self.metric}: {detail}"


class BaselineStore:
    """Append-only benchmark trajectory + context-keyed baseline lookups.

    Appends are O_APPEND single-line writes (concurrent appenders interleave
    whole records, never tear one); reads skip unparseable or
    future-schema lines instead of failing, so a newer writer can't brick an
    older gate.
    """

    def __init__(self, path: Any = TRAJECTORY_PATH):
        self.path = Path(path)

    # -- write ---------------------------------------------------------------
    def append(self, records: Sequence[BenchRecord], *, quick: bool = False,
               sha: Optional[str] = None, timestamp: Optional[float] = None,
               run_id: Optional[str] = None) -> List[Dict[str, Any]]:
        """Append one trajectory line per record; returns the raw dicts."""
        sha = sha if sha is not None else git_sha()
        ts = time.time() if timestamp is None else timestamp
        rows = []
        for r in records:
            rows.append({
                "schema": SCHEMA_VERSION,
                "benchmark": r.benchmark,
                "metric": r.metric,
                "values": [float(v) for v in r.values],
                "context": r.context.to_dict(),
                "mode": r.mode,
                "unit": r.unit,
                "quick": bool(quick),
                "git_sha": sha,
                "timestamp": ts,
                "run_id": run_id,
                "meta": r.meta,
            })
        self.path.parent.mkdir(parents=True, exist_ok=True)
        blob = "".join(json.dumps(row) + "\n" for row in rows)
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, blob.encode())
        finally:
            os.close(fd)
        return rows

    # -- read ----------------------------------------------------------------
    def rows(self) -> Iterator[Dict[str, Any]]:
        if not self.path.exists():
            return
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn/corrupt line: skip, don't brick the gate
                if isinstance(row, dict) and row.get("schema") == SCHEMA_VERSION:
                    yield row

    def history(self, record: BenchRecord, *, quick: Optional[bool] = None,
                window: int = 5) -> List[Dict[str, Any]]:
        """The last ``window`` stored rows matching the record's coordinates.

        Matching is exact on (benchmark, metric, context, quick): a quick
        CI point never gates against a full-budget baseline and a number
        measured on other hardware/software never gates this one.
        """
        ctx = record.context.to_dict()
        matches = [row for row in self.rows()
                   if row["benchmark"] == record.benchmark
                   and row["metric"] == record.metric
                   and row["context"] == ctx
                   and (quick is None or row["quick"] == quick)]
        matches.sort(key=lambda row: row.get("timestamp", 0.0))
        return matches[-window:]

    def baseline_values(self, record: BenchRecord, *, quick: Optional[bool] = None,
                        window: int = 5) -> List[float]:
        """Pooled baseline distribution for a record's coordinates."""
        out: List[float] = []
        for row in self.history(record, quick=quick, window=window):
            out.extend(float(v) for v in row["values"])
        return out

    # -- gate ----------------------------------------------------------------
    def check(self, record: BenchRecord, *, quick: Optional[bool] = None,
              window: int = 5, tolerance: float = 0.25, alpha: float = 0.05,
              seed: int = 0) -> GateReport:
        """Gate one record against its stored baseline distribution.

        ``tolerance`` is the minimum relative shift that counts as a real
        change — run-to-run jitter below it is ``noise`` by construction,
        and even a large shift must also be statistically significant under
        the permutation test to read ``regressed``.  Where the comparator
        falls back to effect-size-only (samples too few for the test to
        reach ``alpha`` — one-shot wall clocks, early history), the gate
        does NOT take the evidence-free verdict: it reports
        ``insufficient_data`` and passes, unlike ``perf.hillclimb`` whose
        singleton inputs are deterministic analytic estimates.
        """
        hist = self.history(record, quick=quick, window=window)
        base = [float(v) for row in hist for v in row["values"]]
        if not base:
            return GateReport(record.benchmark, record.metric, "no_baseline",
                              None, baseline_runs=0, baseline_n=0)
        cmp = stats.compare(base, record.values, alpha=alpha,
                            min_effect=tolerance, mode=record.mode, seed=seed)
        verdict = cmp.verdict
        if verdict != "noise" and cmp.p_value is None:
            verdict = "insufficient_data"
        return GateReport(record.benchmark, record.metric, verdict, cmp,
                          baseline_runs=len(hist), baseline_n=len(base))

    def quantiles(self, record: BenchRecord, qs: Sequence[float], *,
                  quick: Optional[bool] = None, window: int = 5) -> Optional[List[float]]:
        """Baseline-distribution quantiles (RPI bound derivation), or None."""
        import numpy as np

        base = self.baseline_values(record, quick=quick, window=window)
        if not base:
            return None
        return [float(np.quantile(base, q)) for q in qs]
