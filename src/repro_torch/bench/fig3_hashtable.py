"""Paper Fig. 3: tuning two hash-table instances, Random Search against BO.

The twin of the reference's ``benchmarks/fig3_hashtable.py``.  Two
instances mirror OpenRowSet (uniform lookups: a smooth surface) and
BufferManager (skewed lookups: a jagged surface).  Optimizers: Random
Search, BO with the RBF and the Matérn-3/2 kernel over {log2_buckets,
probe, probe_stride} of the port's ``torch_hashtable``, and one-at-a-time
for claim C4.  The reference's instances, optimizers, budget (22), repeats
(3) and seeds are kept.

The objective is the measured latency of one workload batch on the host:
the hash table is numpy, so :func:`~repro_torch.launch.microbench.
time_samples_us` times it with the host's ``perf_counter`` (no CUDA tensor
is passed).  Every such number is named ``host_us``; none is a device
time.  ``backend`` routes the BO arms through the process's optimizer
default for the run: ``"numpy"`` (the reference's surrogate, parity with
it) or ``"torch"``, the port's float64 GP engine on ``device`` (the card
unless the caller asks for the CPU).

Claims (the reference's, printed, not gated):
  C1 tuned beats the default by 20–90% (a ``stats.compare`` verdict);
  C2 the surface differs across workloads;
  C3 RS is competitive with BO;
  C4 multi-parameter search beats one-at-a-time.

Output: ``fig3_hashtable.json`` under ``out_dir`` (by default
``results/torch/bench/``).

    PYTHONPATH=src python -m repro_torch.bench.fig3_hashtable                 # BO on the card
    PYTHONPATH=src python -m repro_torch.bench.fig3_hashtable --device cpu --backend numpy
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, Optional

from ..core import stats
from ..core.optimizers import make_optimizer, optimizer_defaults, set_optimizer_defaults
from ..core.smartcomponents import TunableHashTable, hashtable_workload
from ..core.tracking import Tracker
from ..launch.microbench import time_samples_us
from . import BENCH_ROOT, require_device

INSTANCES = {
    "OpenRowSet": dict(skew=0.0, n_keys=3000, lookup_ratio=4.0),
    "BufferManager": dict(skew=1.2, n_keys=3000, lookup_ratio=4.0),
}
OPTIMIZERS = ["random", "bo_rbf", "bo_matern32", "one_at_a_time"]
BUDGET = 22
REPEATS = 3  # samples per config; aggregation and verdicts go through core.stats


def _measure(table: TunableHashTable, wl: Dict[str, Any], config: Dict[str, Any],
             seed: int) -> Dict[str, Any]:
    """App metrics of one workload run and a host wall-clock sample
    distribution: the objective (its median) and the tuned-vs-default
    verdict share one measurement path."""
    table.apply_and_rebuild(config)
    metrics = dict(hashtable_workload(table, seed=seed, **wl))
    samples = time_samples_us(
        lambda: hashtable_workload(table, seed=seed, **wl), warmup=1, reps=REPEATS)
    metrics["host_samples_us"] = samples
    metrics["host_us"] = stats.median(samples)
    return metrics


def run(tracker: Optional[Tracker] = None, budget: int = BUDGET, *, backend: str = "torch",
        device: Any = "cuda") -> Dict[str, Any]:
    """Per instance: the default's host time, and per optimizer its trace of
    best-so-far host µs, its best config and the C1 verdict."""
    device = require_device(device)
    tracker = tracker or Tracker()
    table = TunableHashTable()
    space = table.mlos_meta.space
    old = optimizer_defaults()
    set_optimizer_defaults(backend=backend, device=str(device))
    results: Dict[str, Any] = {}
    try:
        for inst, wl in INSTANCES.items():
            base_m = _measure(table, wl, space.defaults(), seed=0)
            base = base_m["host_us"]
            inst_res: Dict[str, Any] = {"default_host_us": base, "traces": {}}
            for opt_name in OPTIMIZERS:
                with tracker.start_run("fig3_hashtable", f"{inst}-{opt_name}") as run_:
                    opt = make_optimizer(opt_name, space, seed=17)
                    best, best_samples = base, base_m["host_samples_us"]
                    trace = []
                    for it in range(budget):
                        cfg = opt.ask()
                        m = _measure(table, wl, cfg, seed=0)
                        opt.tell(cfg, m["host_us"])
                        if m["host_us"] < best:
                            best, best_samples = m["host_us"], m["host_samples_us"]
                        trace.append(best)
                        run_.log_metrics({"host_us": m["host_us"], "best_host_us": best},
                                         step=it)
                    run_.log_params(opt.best.config)
                    # C1 is a claim: a stats.compare verdict over the raw samples
                    cmp = stats.compare(base_m["host_samples_us"], best_samples,
                                        mode="min", min_effect=0.02)
                    inst_res["traces"][opt_name] = trace
                    inst_res.setdefault("best", {})[opt_name] = {
                        "host_us": best, "config": opt.best.config,
                        "improvement_pct": 100.0 * (base - best) / base,
                        "verdict": cmp.verdict, "effect": cmp.effect,
                        "p_value": cmp.p_value,
                    }
            results[inst] = inst_res
    finally:
        set_optimizer_defaults(**old)
    return results


def write(res: Dict[str, Any], out_dir: Any = BENCH_ROOT, *, backend: str,
          device: Any) -> Dict[str, Any]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "fig3_hashtable.json").write_text(json.dumps(
        {"backend": backend, "device": str(device), "instances": res}, indent=1))
    print(f"fig3 (hash-table tuning, C1–C4; host µs, BO backend {backend} on {device}):")
    for inst, r in res.items():
        print(f"  {inst}: default={r['default_host_us']:.0f}us")
        for opt, b in r["best"].items():
            print(f"    {opt:14s} best={b['host_us']:.0f}us  improvement="
                  f"{b['improvement_pct']:.1f}%  [{b['verdict']}]")
    return res


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="the BO engine's device: cuda or cpu")
    ap.add_argument("--backend", default="torch", choices=("torch", "numpy"))
    ap.add_argument("--out-dir", default=str(BENCH_ROOT))
    args = ap.parse_args(argv)
    res = run(backend=args.backend, device=args.device)
    return write(res, args.out_dir, backend=args.backend, device=args.device)


if __name__ == "__main__":
    main()
