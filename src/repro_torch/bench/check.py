"""Smoke assertions over the twins' benchmark JSON.

The port of ``benchmarks/check_bench.py``'s ``check_serve_scenarios``,
``check_online_tuning``, ``check_kernel_autotune``,
``check_configstore_resolve``, ``check_fault_tolerance``,
``check_optimizer_throughput``, ``check_campaign_sweep`` and
``check_multi_instance``, reading the JSON each twin writes
(``serve_scenarios.json``, ``online_tuning.json``, ``kernel_autotune.json``,
``configstore_resolve.json``, ``fault_tolerance.json``,
``optimizer_throughput.json``, ``campaign_sweep.json``,
``multi_instance.json``) from a bench directory (by default
:data:`~repro_torch.bench.BENCH_ROOT`).  Each check is filed under the name
of the twin that writes its JSON; the runner calls it after that twin, and
a failing assertion points at a line here.

    PYTHONPATH=src python -m repro_torch.bench.check serve_scenarios online_tuning --expect-quick
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import BENCH_ROOT

SCENARIOS = ("diurnal", "bursts", "heavy_tail")


def _expect(ok: bool, detail: Any = "") -> None:
    """An assertion that ``python -O`` keeps."""
    if not ok:
        raise AssertionError(detail)


def _load(name: str, expect_quick: Optional[bool], bench_dir: Any) -> Dict[str, Any]:
    path = Path(bench_dir) / f"{name}.json"
    d = json.loads(path.read_text())
    if expect_quick is not None and d.get("quick") is not expect_quick:
        raise AssertionError(f"{path}: quick={d.get('quick')!r}, expected {expect_quick}")
    return d


def check_serve_scenarios(expect_quick: Optional[bool] = None,
                          bench_dir: Any = BENCH_ROOT) -> None:
    """Every scenario that ran has samples on both sides and equal token
    totals; the heavy-tail mix ran, and continuous batching beat gang on it
    (a ``stats.compare`` verdict)."""
    d = _load("serve_scenarios", expect_quick, bench_dir)
    _expect(d["scenarios"] and set(d["scenarios"]) <= set(SCENARIOS), d["scenarios"].keys())
    _expect("heavy_tail" in d["scenarios"], "the heavy-tail claim needs the heavy_tail mix")
    for name, row in d["scenarios"].items():
        for mode in ("gang", "continuous"):
            _expect(len(row[mode]["tokens_per_s"]) >= 2, (name, mode))
            _expect(all(s > 0 for s in row[mode]["tokens_per_s"]), (name, mode))
            _expect(all(s >= 0 for s in row[mode]["p99_latency_s"]), (name, mode))
        # identical offered work on both sides, or the A/B is bogus
        _expect(row["gang"]["total_tokens"] == row["continuous"]["total_tokens"], name)
    v = d["heavy_tail_verdict"]
    _expect(v["verdict"] == "improved", (
        f"continuous batching did not beat gang scheduling on the heavy-tail mix: {v}"))
    _expect(v["candidate_location"] > v["baseline_location"], v)


def check_online_tuning(expect_quick: Optional[bool] = None,
                        bench_dir: Any = BENCH_ROOT) -> None:
    """At least one canary promoted, every canary but a trailing one closed,
    one rollback row per rollback, and the tuned config beat the frozen one
    (a ``stats.compare`` verdict)."""
    d = _load("online_tuning", expect_quick, bench_dir)
    a = d["adapt"]
    _expect(a["promotions"] >= 1, f"no canary promoted: {a}")
    kinds = a["transitions"]
    _expect("canary_start" in kinds and "canary_verdict" in kinds, kinds)
    _expect("promote" in kinds, kinds)
    # at most ONE canary still in flight when the adapt loop stopped, and
    # only as the journal's trailing record
    open_canaries = kinds.count("canary_start") - kinds.count("canary_verdict")
    _expect(open_canaries in (0, 1), kinds)
    if open_canaries:
        _expect(kinds[-1] == "canary_start", kinds)
    _expect(kinds.count("rollback") == a["rollbacks"], (kinds, a))
    _expect(len(d["frozen_tokens_per_s"]) >= 2, d["frozen_tokens_per_s"])
    _expect(all(s > 0 for s in d["frozen_tokens_per_s"] + d["tuned_tokens_per_s"]), d)
    v = d["verdict"]
    _expect(v["verdict"] == "improved", (
        f"online tuning did not recover the traffic-mix shift: {v}"))
    _expect(v["candidate_location"] > v["baseline_location"], v)


def check_kernel_autotune(expect_quick: Optional[bool] = None,
                          bench_dir: Any = BENCH_ROOT) -> None:
    d = _load("kernel_autotune", expect_quick, bench_dir)
    _expect(d["default_us"] > 0 and d["best_us"] > 0, d)
    _expect(d["best_us"] <= d["default_us"], "tuned config slower than default")
    _expect(d["trace"], "no tuning trace recorded")
    _expect(len(d["best_samples_us"]) > 0 and len(d["default_samples_us"]) > 0, d)


def check_configstore_resolve(expect_quick: Optional[bool] = None,
                              bench_dir: Any = BENCH_ROOT) -> None:
    d = _load("configstore_resolve", expect_quick, bench_dir)
    _expect(d["fresh_process_resolution"] == "ok", d.get("fresh_process_resolution"))
    wls = [c["workload"] for c in d["contexts"].values()]
    _expect(len(wls) == 2 and len(set(wls)) == 2, wls)
    _expect(d["resolve"]["cached_ns_per_lookup"] > 0, d["resolve"])
    _expect(d["resolve"]["uncached_first_ms"] > 0, d["resolve"])
    _expect(len(d["resolve"]["cached_ns_samples"]) > 0, d["resolve"])
    _expect(len(d["resolve"]["uncached_ms_samples"]) >= 2, d["resolve"])


def check_fault_tolerance(expect_quick: Optional[bool] = None,
                          bench_dir: Any = BENCH_ROOT) -> None:
    """Every kill restarted once and resumed bit-identically, every resume
    timed, the torn newest checkpoint fell back, the killed campaign
    re-measured nothing it had finished, and async checkpointing beat
    blocking on blocked time (a ``stats.compare`` verdict)."""
    d = _load("fault_tolerance", expect_quick, bench_dir)
    tr = d["train"]
    _expect(tr["kills"] >= 1 and tr["restarts"] == tr["kills"], tr)
    _expect(tr["overlap_identical"], "re-executed steps diverged from first run")
    _expect(tr["bit_identical"], "resumed loss trajectory is not bit-identical to uninterrupted")
    _expect(len(tr["recovery_s"]) == tr["kills"], tr["recovery_s"])
    _expect(all(s > 0 for s in tr["recovery_s"]), tr["recovery_s"])
    _expect(d["torn"]["fell_back"], f"corrupt newest checkpoint did not fall back: {d['torn']}")
    ca = d["campaign"]
    _expect(ca["completed_before_kill"] >= 1, ca)
    _expect(ca["replayed_completed_evals"] == 0,
            f"resume re-measured evals of completed cells: {ca}")
    _expect(ca["cells_resumed_exactly"] >= 1, ca)
    v = d["ckpt_overhead"]["verdict"]
    _expect(v["verdict"] == "improved",
            f"async checkpointing did not beat blocking on blocked time: {v}")
    _expect(v["candidate_location"] < v["baseline_location"], v)


def check_optimizer_throughput(expect_quick: Optional[bool] = None,
                               bench_dir: Any = BENCH_ROOT) -> None:
    d = _load("optimizer_throughput", expect_quick, bench_dir)
    _expect(d["ask_latency_ms"], "no ask-latency points recorded")
    for n, row in d["ask_latency_ms"].items():
        _expect(row["numpy"] > 0 and row["torch"] > 0 and row["speedup"] > 0, (n, row))
        _expect(len(row["numpy_samples"]) > 0 and len(row["torch_samples"]) > 0, (n, row))
    _expect(d["batched"], "no batched points recorded")
    for n, row in d["batched"].items():
        _expect(row["sessions"] >= 2 and row["batched_ms"] > 0, (n, row))


def check_campaign_sweep(expect_quick: Optional[bool] = None,
                         bench_dir: Any = BENCH_ROOT) -> None:
    d = _load("campaign_sweep", expect_quick, bench_dir)
    _expect(d["cells"], "no campaign cells recorded")
    _expect(d["warm_iters_total"] < d["cold_iters_total"], (
        f"warm-start did not beat cold: warm {d['warm_iters_total']} vs "
        f"cold {d['cold_iters_total']} total iterations-to-best"))
    for cid, row in d["cells"].items():
        _expect(row["promoted"], f"{cid}: best config was not promoted")
        _expect(row["warm_source"], f"{cid}: warm cell has no transfer source")


def check_multi_instance(expect_quick: Optional[bool] = None,
                         bench_dir: Any = BENCH_ROOT) -> None:
    d = _load("multi_instance", expect_quick, bench_dir)
    _expect(d["instances"], "no instances recorded")
    for name, row in d["instances"].items():
        _expect(row["no_worse"], (f"{name}: multiplexed best {row['multiplexed_best']} worse "
                                  f"than baseline {row['baseline_best']}"))


CHECKS = {
    "serve_scenarios": check_serve_scenarios,
    "online_tuning": check_online_tuning,
    "kernel_autotune": check_kernel_autotune,
    "configstore_roundtrip": check_configstore_resolve,
    "fault_tolerance": check_fault_tolerance,
    "optimizer_throughput": check_optimizer_throughput,
    "campaign_sweep": check_campaign_sweep,
    "multi_instance": check_multi_instance,
}


def run_checks(names: List[str], expect_quick: Optional[bool] = None,
               bench_dir: Any = BENCH_ROOT) -> None:
    for name in names:
        CHECKS[name](expect_quick=expect_quick, bench_dir=bench_dir)
        print(f"check {name}: ok")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("names", nargs="*", default=list(CHECKS), choices=list(CHECKS))
    ap.add_argument("--expect-quick", action="store_true")
    ap.add_argument("--dir", default=str(BENCH_ROOT), help="bench directory to read")
    args = ap.parse_args(argv)
    run_checks(args.names or list(CHECKS), expect_quick=True if args.expect_quick else None,
               bench_dir=args.dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
