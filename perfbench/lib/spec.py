"""Finding a cell's files by name.

``BENCHMARK.json`` (at the root of the checkout) names the cells, the
configurations and the metrics.  A cell ``<cell>`` is described by
``perfbench/workloads/<cell>.json`` (its kind, pinned settings and the
limits of its comparison), its configuration by the file that
``BENCHMARK.json`` gives, its traffic by ``perfbench/traffic/<traffic>.json``
and each metric by ``perfbench/metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


class Spec:
    """One cell: its ``BENCHMARK.json`` entry, its file, its configuration
    and its traffic."""

    def __init__(self, cell: str, root: Path = ROOT):
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if cell not in entries:
            raise KeyError(f"no cell {cell!r} in BENCHMARK.json (have {sorted(entries)})")
        self.name = cell
        self.entry = entries[cell]
        self.cell = load_json(root / "perfbench" / "workloads" / f"{cell}.json")
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(root / "perfbench" / "traffic" / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])

    def end_to_end(self) -> List[Dict[str, Any]]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[Dict[str, Any]]:
        """The per-layer metrics read in this cell's traced run: those that
        list it, and those without a list whose end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def metric_reader(name: str, root: Path = ROOT) -> Callable[[Any], Any]:
    """``value(record)`` of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.value


class Run:
    """The inputs of one run: the cell, ``--seed``, ``--seconds``, ``--trace``,
    the device, and the process's start on the host's monotonic clock.
    ``step`` overrides the server's step mode (``eager`` off the card)."""

    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool, device: Any,
                 started: float, step: Any = None):
        self.spec, self.seed, self.seconds, self.trace = spec, seed, seconds, trace
        self.device, self.started, self.step = device, started, step


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error, seconds since the harness loaded."""
    print(f"[{time.perf_counter() - _T0:8.1f} s] {msg}", file=sys.stderr, flush=True)
