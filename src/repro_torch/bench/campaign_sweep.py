"""Campaign warm-start transfer: iterations-to-best, warm against cold.

The twin of the reference's ``benchmarks/campaign_sweep.py``.  A cell
warm-started from the nearest stored context must reach
within-tolerance-of-best in fewer evaluations than the identical cell
cold-started.  A deterministic objective is planted whose optimum drifts
smoothly across workload buckets (neighbouring shape buckets prefer
neighbouring configs); source buckets are tuned into a config store, then
target buckets twice, cold (a fresh store) and warm (the source store), with
identical seeds.  The reference's component space (the port's
``torch_hashtable``), drift, seeds, budgets and buckets are kept.

``backend`` picks the BO surrogate of every cell for the run: the numpy
default, or ``"torch"``, the GP engine on ``device`` (the card unless the
caller asks for the CPU), where warm starts reach it through
``inject_prior`` → ``seed_observations``.  Stores and journals go under
``out_dir``/``campaign_sweep/`` (by default ``results/torch/bench/``), and
every promoted entry is filed under this process's hardware fingerprint.
Outputs: ``campaign_sweep.json`` under ``out_dir``.

    PYTHONPATH=src python -m repro_torch.bench.campaign_sweep --quick
    PYTHONPATH=src python -m repro_torch.bench.campaign_sweep --backend torch   # on the card
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..core import smartcomponents as _smart  # noqa: F401 — registers torch_hashtable
from ..core.campaign import Campaign, CampaignCell, evals_to_reach
from ..core.configstore import ConfigStore, context_for, hardware_fingerprint
from ..core.optimizers import optimizer_defaults, set_optimizer_defaults
from ..core.registry import get_component
from . import BENCH_ROOT

COMPONENT = "torch_hashtable"    # borrowed 3-d tunable space; objective is synthetic
OBJECTIVE = "time_us"
DRIFT = 0.04                     # optimum shift per log2 bucket step


def planted_measure(seed: int):
    """Squared distance (in encoded space) to a per-workload optimum that
    drifts DRIFT per bucket step: a neighbour bucket's best config is
    informative but not optimal here."""
    space = get_component(COMPONENT).space
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.25, 0.75, size=len(space))

    def target(workload: str) -> np.ndarray:
        return np.clip(base + DRIFT * np.log2(float(workload.lstrip("s"))), 0.0, 1.0)

    def measure(cell: CampaignCell, settings: Dict[str, Any]) -> Dict[str, float]:
        x = space.encode(space.validate(settings))
        v = float(np.sum((x - target(cell.workload)) ** 2)) * 1000.0
        return {"time_us": v, "collisions": int(v), "memory_bytes": 1, "load_factor_ppm": 1}

    return measure


def _cells(workloads: List[str], budget: int, seed: int) -> List[CampaignCell]:
    return [CampaignCell(COMPONENT, wl, OBJECTIVE, optimizer="bo", budget=budget, seed=seed + i)
            for i, wl in enumerate(workloads)]


def run(quick: bool = False, seed: int = 7, *, backend: str = "numpy", device: Any = "cuda",
        out_dir: Any = BENCH_ROOT) -> Dict[str, Any]:
    sources = ["s128", "s1024"]
    targets = ["s256", "s2048"] if quick else ["s256", "s512", "s2048", "s4096"]
    budget = 10 if quick else 14
    measure = planted_measure(seed)
    work = Path(out_dir) / "campaign_sweep"
    if work.exists():
        shutil.rmtree(work)  # journals must not resume across bench runs
    old = optimizer_defaults()
    set_optimizer_defaults(backend=backend, device=str(device))
    t0 = time.time()
    try:
        warm_store = ConfigStore(root=str(work / "store_warm"))
        cold_store = ConfigStore(root=str(work / "store_cold"))
        Campaign(_cells(sources, budget + 4, seed), measure, campaign_id="sweep-src",
                 store=warm_store, journal_root=str(work)).run()
        cold = Campaign(_cells(targets, budget, seed + 100), measure, campaign_id="sweep-cold",
                        store=cold_store, journal_root=str(work), warm_start=False).run()
        warm = Campaign(_cells(targets, budget, seed + 100), measure, campaign_id="sweep-warm",
                        store=warm_store, journal_root=str(work), warm_start=True).run()
    finally:
        set_optimizer_defaults(**old)

    res: Dict[str, Any] = {"quick": quick, "seed": seed, "budget": budget, "sources": sources,
                           "backend": backend, "device": str(device) if backend == "torch"
                           else None, "hardware": hardware_fingerprint(), "cells": {}}
    cold_iters, warm_iters = [], []
    for wl in targets:
        cid = f"{COMPONENT}@{wl}"
        c, w = cold[cid], warm[cid]
        # One shared goalpost per cell: the better of the two runs' bests.
        goal = min(c.best_value, w.best_value)
        ci = evals_to_reach(c.values, goal, tol=0.10) or budget + 1
        wi = evals_to_reach(w.values, goal, tol=0.10) or budget + 1
        cold_iters.append(ci)
        warm_iters.append(wi)
        entry = warm_store.resolve_entry(context_for(COMPONENT, wl))
        res["cells"][cid] = {
            "cold_iters": ci, "warm_iters": wi,
            "cold_best": c.best_value, "warm_best": w.best_value,
            "warm_source": (w.warm_start or {}).get("source_workload"),
            "promoted": w.promoted,
            "promoted_under": entry["context"]["hardware"] if entry and w.promoted else None,
        }
    res["cold_iters_total"] = int(sum(cold_iters))
    res["warm_iters_total"] = int(sum(warm_iters))
    res["wall_s"] = time.time() - t0

    print(f"campaign warm-start transfer over {len(targets)} cells (budget {budget}/cell, "
          f"planted drift {DRIFT}/bucket-step, bo backend {backend}"
          + (f" on {device}" if backend == "torch" else "") + "):")
    for cid, row in res["cells"].items():
        print(f"  {cid:24s} cold {row['cold_iters']:3d} evals → warm {row['warm_iters']:3d} "
              f"evals  (source {row['warm_source']}, promoted under {row['promoted_under']})")
    print(f"  total iterations-to-best: cold {res['cold_iters_total']} → warm "
          f"{res['warm_iters_total']}; wall {res['wall_s']:.2f} s")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "campaign_sweep.json").write_text(json.dumps(res, indent=1))
    return res


def bench(quick: bool = False, seed: int = 7, *, device: Any = "cuda",
          out_dir: Any = BENCH_ROOT) -> List[Any]:
    """Runner protocol: the warm-vs-cold iterations-to-best metric, one sample
    per target cell (fewer evaluations is better).  The runner runs the
    numpy default, as the reference's does."""
    from ..core.baseline import BenchRecord

    res = run(quick=quick, seed=seed, device=device, out_dir=out_dir)
    wl = f"synthetic_x{len(res['cells'])}b{res['budget']}"
    meta = dict(sources=len(res["sources"]), budget=res["budget"])
    return [BenchRecord.for_component("campaign_sweep", f"{side}_iters_to_best",
                                      [row[f"{side}_iters"] for row in res["cells"].values()],
                                      "campaign", wl, unit="evals", **meta)
            for side in ("warm", "cold")]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--backend", default="numpy", choices=("numpy", "torch"))
    ap.add_argument("--device", default="cuda", help="the torch engine's: cuda (default) or cpu")
    ap.add_argument("--out-dir", default=str(BENCH_ROOT))
    args = ap.parse_args(argv)
    res = run(quick=args.quick, seed=args.seed, backend=args.backend, device=args.device,
              out_dir=args.out_dir)
    # Strict, matching check.check_campaign_sweep: a tie fails the transfer claim.
    return 0 if res["warm_iters_total"] < res["cold_iters_total"] else 1


if __name__ == "__main__":
    sys.exit(main())
