"""Experiment tracking — the run store of the MLOS data-science side.

The port of ``repro/core/tracking.py``.  Every tuning experiment records
params / metrics / tags / artifacts under ``<experiment>/<run_id>/`` of a
root (by default :data:`RUNS_ROOT`, the repository's
``results/torch/runs/``, apart from the reference's ``results/runs/``), so
the history is reproducible and queryable: the paper's "versioning and
tracking of all models/experiments".
"""
from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Tracker", "Run", "RunRecord", "RUNS_ROOT"]

RUNS_ROOT = Path(__file__).resolve().parents[3] / "results" / "torch" / "runs"


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except TypeError:
        return repr(v)


class Run:
    def __init__(self, path: Path, run_id: str, experiment: str):
        self.path = path
        self.run_id = run_id
        self.experiment = experiment
        self._metrics_f = open(path / "metrics.jsonl", "a")
        self._meta = {"run_id": run_id, "experiment": experiment, "start_time": time.time(), "status": "RUNNING"}
        self._flush_meta()
        self.params: Dict[str, Any] = {}
        self.tags: Dict[str, Any] = {}

    def _flush_meta(self) -> None:
        (self.path / "meta.json").write_text(json.dumps(self._meta, indent=1))

    def log_params(self, params: Dict[str, Any]) -> None:
        self.params.update({k: _jsonable(v) for k, v in params.items()})
        (self.path / "params.json").write_text(json.dumps(self.params, indent=1))

    def set_tags(self, tags: Dict[str, Any]) -> None:
        self.tags.update({k: _jsonable(v) for k, v in tags.items()})
        (self.path / "tags.json").write_text(json.dumps(self.tags, indent=1))

    def log_metric(self, name: str, value: float, step: int = 0) -> None:
        self._metrics_f.write(json.dumps({"name": name, "value": float(value), "step": step, "t": time.time()}) + "\n")
        self._metrics_f.flush()

    def log_metrics(self, metrics: Dict[str, float], step: int = 0) -> None:
        for k, v in metrics.items():
            self.log_metric(k, v, step)

    def log_artifact(self, name: str, content: str) -> Path:
        d = self.path / "artifacts"
        d.mkdir(exist_ok=True)
        p = d / name
        p.write_text(content)
        return p

    def end(self, status: str = "FINISHED", error: Optional[str] = None) -> None:
        """Idempotent: a run already ended (or double-__exit__ed) stays ended
        with its first verdict — crash paths can call this unconditionally."""
        if self._metrics_f.closed:
            return
        self._meta["status"] = status
        self._meta["end_time"] = time.time()
        if error is not None:
            self._meta["error"] = error
        self._flush_meta()
        self._metrics_f.close()

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, et: Any, ev: Any, tb: Any) -> None:
        # A crashing run must not leak the metrics handle or stay RUNNING
        # forever: mark FAILED and record what killed it.
        self.end("FAILED" if et else "FINISHED", error=repr(ev) if et else None)


@dataclass
class RunRecord:
    run_id: str
    experiment: str
    params: Dict[str, Any] = field(default_factory=dict)
    tags: Dict[str, Any] = field(default_factory=dict)
    metrics: Dict[str, List[Dict[str, Any]]] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    def last(self, metric: str, default: Optional[float] = None) -> Optional[float]:
        hist = self.metrics.get(metric)
        return hist[-1]["value"] if hist else default

    def min(self, metric: str) -> Optional[float]:
        hist = self.metrics.get(metric)
        return min(h["value"] for h in hist) if hist else None


class Tracker:
    def __init__(self, root: Any = RUNS_ROOT):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def start_run(self, experiment: str, run_name: Optional[str] = None) -> Run:
        run_id = run_name or f"{time.strftime('%Y%m%d-%H%M%S')}-{uuid.uuid4().hex[:6]}"
        path = self.root / experiment / run_id
        path.mkdir(parents=True, exist_ok=True)
        return Run(path, run_id, experiment)

    def runs(self, experiment: str) -> Iterator[RunRecord]:
        exp_dir = self.root / experiment
        if not exp_dir.exists():
            return
        for run_dir in sorted(exp_dir.iterdir()):
            if not run_dir.is_dir():
                continue
            rec = RunRecord(run_dir.name, experiment)
            for fname, attr in (("params.json", "params"), ("tags.json", "tags"), ("meta.json", "meta")):
                p = run_dir / fname
                if p.exists():
                    setattr(rec, attr, json.loads(p.read_text()))
            mpath = run_dir / "metrics.jsonl"
            if mpath.exists():
                for line in mpath.read_text().splitlines():
                    if not line.strip():
                        continue
                    ev = json.loads(line)
                    rec.metrics.setdefault(ev["name"], []).append(ev)
            yield rec

    def best_run(self, experiment: str, metric: str, mode: str = "min") -> Optional[RunRecord]:
        best, best_v = None, None
        for rec in self.runs(experiment):
            if mode == "min":
                v = rec.min(metric)
            else:
                hist = rec.metrics.get(metric)
                v = max(h["value"] for h in hist) if hist else None
            if v is None:
                continue
            if best_v is None or (v < best_v if mode == "min" else v > best_v):
                best, best_v = rec, v
        return best
