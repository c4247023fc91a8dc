"""The port's benchmark runner: one protocol, one record schema, one gate.

The port of ``benchmarks/runner.py`` over the port's twins only
(``serve_scenarios``, ``online_tuning``, ``kernel_autotune``,
``configstore_roundtrip``, ``fault_tolerance``, ``optimizer_throughput``,
``campaign_sweep``, ``multi_instance``, ``compile_cold_warm``).  Every
registered benchmark exposes ``bench(quick, seed, device=, out_dir=) ->
[BenchRecord]``; the runner runs them, checks each twin's JSON
(:mod:`.check`), gates each record against its stored context-keyed
baseline distribution (:mod:`repro_torch.core.baseline`), appends the run to
the trajectory (by default the repository's
``results/torch/bench/trajectory.jsonl``) so it becomes the next run's
baseline, and writes ``gate_report.json`` into the output directory (by
default ``results/torch/bench/``).  Nothing lands in the reference's
``results/bench/``.

Verdicts come from the ``core.stats`` comparator: ``regressed`` requires a
statistically significant shift beyond ``--tolerance``.  A run with no
stored history reads ``no_baseline`` and passes.  Records carry this
process's hardware fingerprint, so a CPU run never gates a card run.

    PYTHONPATH=src python -m repro_torch.bench.runner --quick --gate              # on the card
    PYTHONPATH=src python -m repro_torch.bench.runner --quick --gate --device cpu
    PYTHONPATH=src python -m repro_torch.bench.runner --list
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from ..core.baseline import TRAJECTORY_PATH, BaselineStore, BenchRecord
from . import BENCH_ROOT, check

# name -> bench(quick, seed, device=, out_dir=) -> List[BenchRecord].  Import
# inside the thunk: a benchmark with a broken import must not take down the
# whole runner list.
REGISTRY: Dict[str, Callable[..., List[BenchRecord]]] = {}


def register(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


@register("serve_scenarios")
def _serve_scenarios(quick: bool, seed: int, **kw: Any) -> List[BenchRecord]:
    from . import serve_scenarios as m
    return m.bench(quick=quick, seed=seed, **kw)


@register("online_tuning")
def _online_tuning(quick: bool, seed: int, **kw: Any) -> List[BenchRecord]:
    from . import online_tuning as m
    return m.bench(quick=quick, seed=seed, **kw)


@register("kernel_autotune")
def _kernel_autotune(quick: bool, seed: int, **kw: Any) -> List[BenchRecord]:
    from . import kernel_autotune as m
    return m.bench(quick=quick, seed=seed, **kw)


@register("configstore_roundtrip")
def _configstore_roundtrip(quick: bool, seed: int, **kw: Any) -> List[BenchRecord]:
    from . import configstore_roundtrip as m
    return m.bench(quick=quick, seed=seed, **kw)


@register("fault_tolerance")
def _fault_tolerance(quick: bool, seed: int, **kw: Any) -> List[BenchRecord]:
    from . import fault_tolerance as m
    return m.bench(quick=quick, seed=seed, **kw)


@register("optimizer_throughput")
def _optimizer_throughput(quick: bool, seed: int, **kw: Any) -> List[BenchRecord]:
    from . import optimizer_throughput as m
    return m.bench(quick=quick, seed=seed, **kw)


@register("campaign_sweep")
def _campaign_sweep(quick: bool, seed: int, **kw: Any) -> List[BenchRecord]:
    from . import campaign_sweep as m
    return m.bench(quick=quick, seed=seed, **kw)


@register("multi_instance")
def _multi_instance(quick: bool, seed: int, **kw: Any) -> List[BenchRecord]:
    from . import multi_instance as m
    return m.bench(quick=quick, seed=seed, **kw)


@register("compile_cold_warm")
def _compile_cold_warm(quick: bool, seed: int, **kw: Any) -> List[BenchRecord]:
    from . import compile_cold_warm as m
    return m.bench(quick=quick, seed=seed, **kw)


def run_and_gate(names: List[str], *, quick: bool, seed: int, gate: bool,
                 tolerance: float, window: int, alpha: float, device: Any = "cuda",
                 trajectory: Any = TRAJECTORY_PATH, out_dir: Any = BENCH_ROOT,
                 smoke: bool = True) -> Dict[str, Any]:
    """Run benchmarks, gate against stored baselines, append the trajectory.

    Returns the gate report dict; ``report["ok"]`` is the exit verdict.
    Records are checked against history *before* this run is appended — a
    run never gates against itself.
    """
    store = BaselineStore(trajectory)
    report: Dict[str, Any] = {"quick": quick, "seed": seed, "device": str(device),
                              "tolerance": tolerance, "window": window,
                              "alpha": alpha, "results": [], "ok": True, "appended": 0}
    for name in names:
        print(f"\n=== {name} " + "=" * max(1, 60 - len(name)))
        records = REGISTRY[name](quick, seed, device=device, out_dir=out_dir)
        if smoke and name in check.CHECKS:      # each twin's smoke check has its name
            check.run_checks([name], expect_quick=quick or None, bench_dir=out_dir)
        for rec in records:
            gr = store.check(rec, quick=quick, window=window,
                             tolerance=tolerance, alpha=alpha)
            report["results"].append({
                "benchmark": rec.benchmark, "metric": rec.metric,
                "context": rec.context.to_dict(), "verdict": gr.verdict,
                "baseline_runs": gr.baseline_runs,
                "comparison": gr.comparison.to_dict() if gr.comparison else None,
            })
            if gate and not gr.ok:
                report["ok"] = False
            marker = {"regressed": "✗", "improved": "▲", "noise": "·",
                      "no_baseline": "∅", "insufficient_data": "?"}[gr.verdict]
            print(f"  {marker} {gr.describe()}")
        report["appended"] += len(store.append(records, quick=quick))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "gate_report.json").write_text(json.dumps(report, indent=1))
    print(f"\nappended {report['appended']} records → {trajectory}; "
          f"gate report → {out / 'gate_report.json'}")
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="seconds-scale budgets; gates against quick baselines")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 on a statistically significant regression")
    ap.add_argument("--seed", type=int, default=7,
                    help="base seed threaded into every benchmark")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated subset of registered benchmarks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tolerance", type=float, default=0.25,
                    help="min relative shift that can count as a regression")
    ap.add_argument("--alpha", type=float, default=0.05,
                    help="significance level of the permutation test")
    ap.add_argument("--window", type=int, default=5,
                    help="pool the last N stored runs as the baseline")
    ap.add_argument("--trajectory", type=str, default=str(TRAJECTORY_PATH))
    ap.add_argument("--out-dir", type=str, default=str(BENCH_ROOT),
                    help="where the twins' JSON and gate_report.json go")
    ap.add_argument("--no-smoke", action="store_true",
                    help="skip the check.py smoke assertions")
    ap.add_argument("--list", action="store_true",
                    help="list registered benchmarks and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name in REGISTRY:
            print(name)
        return 0
    names = list(REGISTRY) if args.only is None else args.only.split(",")
    unknown = [n for n in names if n not in REGISTRY]
    if unknown:
        ap.error(f"unknown benchmarks {unknown}; registered: {list(REGISTRY)}")

    report = run_and_gate(names, quick=args.quick, seed=args.seed,
                          gate=args.gate, tolerance=args.tolerance,
                          window=args.window, alpha=args.alpha, device=args.device,
                          trajectory=args.trajectory, out_dir=args.out_dir,
                          smoke=not args.no_smoke)
    regressed = [r for r in report["results"] if r["verdict"] == "regressed"]
    if args.gate and regressed:
        print(f"\nBENCH GATE: FAIL — {len(regressed)} significant regression(s):")
        for r in regressed:
            print(f"  ✗ {r['benchmark']}:{r['metric']} "
                  f"effect {r['comparison']['effect']:+.1%} "
                  f"p={r['comparison']['p_value']}")
        return 1
    if args.gate:
        print("\nBENCH GATE: PASS (regressions beyond tolerance: none)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
