"""Paper Fig. 5: the optimal spinlock max-spin shifts with the workload.

The twin of the reference's ``benchmarks/fig5_spinlock.py``.  Seven
workloads: several light threads plus one thread doing 1× … 64× the work
under the lock (the port's ``torch_spinlock``, a deterministic
discrete-event model).  For each, max_spin is swept over a log grid and a
BO arm (Matérn-3/2, 14 steps, seed 5) looks for the optimum too: claim C6,
subtle workload changes move the optimum substantially.  The reference's
``HEAVY``, ``GRID`` and ``SEEDS`` are kept; :func:`run` reads them when it
is called.  The throughputs are the model's simulated operations per
second, not a time measured on any machine.

``backend`` routes the BO arm through the process's optimizer default for
the run: ``"numpy"``, with which :func:`run` returns the reference's dict
bit for bit, or ``"torch"``, the port's float64 GP engine on ``device``
(the card unless the caller asks for the CPU).

Output: ``fig5_spinlock.json`` under ``out_dir`` (by default
``results/torch/bench/``).

    PYTHONPATH=src python -m repro_torch.bench.fig5_spinlock                  # BO on the card
    PYTHONPATH=src python -m repro_torch.bench.fig5_spinlock --device cpu --backend numpy
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ..core import stats
from ..core.optimizers import make_optimizer, optimizer_defaults, set_optimizer_defaults
from ..core.smartcomponents import SpinLock, spinlock_workload
from . import BENCH_ROOT, require_device

HEAVY = [1, 2, 4, 8, 16, 32, 64]
GRID = [int(x) for x in np.unique(np.logspace(0, 5, 16).astype(int))]
SEEDS = (3, 4, 5)  # the model is deterministic per seed: vary the seed, not reps
BO_STEPS = 14
BO_SEED = 5


def _tput_samples(lock: SpinLock, heavy: int) -> list:
    """Per-seed throughput samples: the distribution core.stats verdicts need."""
    return [spinlock_workload(lock, heavy_ops=heavy, seed=s)["throughput_ops_s"]
            for s in SEEDS]


def run(*, backend: str = "torch", device: Any = "cuda") -> Dict[str, Any]:
    """Per workload: the grid's throughputs, the best spin on the grid and
    by BO, and the best grid spin against the default (a verdict)."""
    device = require_device(device)
    lock = SpinLock()
    default_spin = lock.mlos_meta.space.defaults()["max_spin"]
    out: Dict[str, Any] = {"grid": GRID, "workloads": {}}
    old = optimizer_defaults()
    set_optimizer_defaults(backend=backend, device=str(device))
    try:
        for heavy in HEAVY:
            tput, samples = [], []
            for spin in GRID:
                lock.apply_settings({"max_spin": spin})
                s = _tput_samples(lock, heavy)
                samples.append(s)
                tput.append(stats.median(s))
            best_i = max(range(len(GRID)), key=lambda i: tput[i])
            lock.apply_settings({"max_spin": default_spin})
            cmp = stats.compare(_tput_samples(lock, heavy), samples[best_i],
                                mode="max", min_effect=0.02)
            opt = make_optimizer("bo_matern32", lock.mlos_meta.space, seed=BO_SEED)
            for _ in range(BO_STEPS):
                cfg = opt.ask()
                lock.apply_settings(cfg)
                m = spinlock_workload(lock, heavy_ops=heavy, seed=3)
                opt.tell(cfg, -m["throughput_ops_s"])
            out["workloads"][str(heavy)] = {
                "throughput": tput,
                "best_spin_grid": GRID[best_i],
                "best_spin_bo": opt.best.config["max_spin"],
                "vs_default": {"verdict": cmp.verdict, "effect": cmp.effect,
                               "p_value": cmp.p_value},
            }
    finally:
        set_optimizer_defaults(**old)
    return out


def write(res: Dict[str, Any], out_dir: Any = BENCH_ROOT, *, backend: str,
          device: Any) -> Dict[str, Any]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "fig5_spinlock.json").write_text(json.dumps(
        {**res, "backend": backend, "device": str(device)}, indent=1))
    print(f"fig5 (optimal spin vs workload, C6; BO backend {backend} on {device}):")
    for heavy, r in res["workloads"].items():
        print(f"  heavy_ops={heavy:>3s}: best max_spin (grid)={r['best_spin_grid']:>6d} "
              f"(BO)={r['best_spin_bo']:>6d}  [{r['vs_default']['verdict']} vs default]")
    spins = [r["best_spin_grid"] for r in res["workloads"].values()]
    print(f"  optimum range across workloads: {min(spins)} .. {max(spins)}")
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
