"""Suggest-path throughput: the numpy reference against the torch GP engine.

The twin of the reference's ``benchmarks/optimizer_throughput.py``.  MLOS's
continuous-tuning pitch only holds if the agent's ask is cheap enough to
run inline with the system it tunes.  This measures BO ``ask`` latency
against history size (the numpy backend refits an O(n³) GP per ask; the
torch engine amortizes to a rank-1 update and one captured program) and
the mux-wide batched ask (8 sessions priced in one program against 8
sequential asks).  The reference's space, objective, seeds and sizes are
kept; its ``jax`` column is ``torch`` here, on ``device`` (the card unless
the caller asks for the CPU).  Beyond the reference it records the torch
engine's tell and refit times and its programs' runs, captures and replays
per key (:func:`~repro_torch.core.compilecache.step_counts`).  Outputs:
``optimizer_throughput.json`` under ``out_dir`` (by default
``results/torch/bench/``).

    PYTHONPATH=src python -m repro_torch.bench.optimizer_throughput --quick --device cpu
    PYTHONPATH=src python -m repro_torch.bench.optimizer_throughput            # on the card
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.compilecache import step_counts
from ..core.optimizers import BayesOpt
from ..core.optimizers.engine import BatchedBayesOpt
from ..core.tunable import Categorical, Float, Int, TunableSpace
from . import BENCH_ROOT, require_device

SPACE = TunableSpace([
    Int("log2_buckets", 12, 8, 20),
    Categorical("probe", "linear", ("linear", "quadratic", "double")),
    Int("prefetch", 2, 1, 8),
    Float("alpha", 0.5, 0.0, 1.0),
    Float("lr", 1e-3, 1e-5, 1e-1, log=True),
    Categorical("vectorized", False, (False, True)),
])


def objective(cfg: Dict[str, Any]) -> float:
    x = SPACE.encode(cfg)
    return float(((x - 0.37) ** 2).sum() + 0.05 * np.sin(13 * x).sum())


def with_history(backend: str, seed: int, n: int, device: Any = "cuda",
                 fit_hypers: bool = True) -> BayesOpt:
    opt = BayesOpt(SPACE, seed=seed, backend=backend, device=device, fit_hypers=fit_hypers)
    rng = np.random.default_rng(1000 + seed)
    for _ in range(n):
        cfg = SPACE.sample(rng)
        opt.tell(cfg, objective(cfg))
    return opt


def _samples(fn: Callable[[], Any], reps: int, sync: Callable[[], None]) -> List[float]:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def run(quick: bool = False, seed: int = 7, *, device: Any = "cuda") -> Dict[str, Any]:
    """Measure; all randomness derives from ``seed``.  An ask ends in a
    device→host copy of its argmax, so its host time includes the device's."""
    device = require_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    ns = [25] if quick else [25, 100, 200]
    np_reps = 5 if quick else 4
    tt_reps = 5 if quick else 20
    n_sessions = 8
    sess_hists = [16] if quick else [25, 100]
    steps_before = step_counts()
    res: Dict[str, Any] = {
        "quick": bool(quick), "seed": int(seed), "d": len(SPACE), "n_candidates": 1280,
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "ask_latency_ms": {}, "batched": {}, "engine": {},
    }
    print(f"BO ask latency, d={len(SPACE)}, pool=1280 candidates, torch engine on "
          f"{res['device_name']}")
    for n in ns:
        t_np = _samples(with_history("numpy", seed, n).ask, np_reps, lambda: None)
        opt = with_history("torch", seed, n, device)
        first = _samples(opt.ask, 2, sync)                  # capture + refit, then warm
        t_tt = _samples(opt.ask, tt_reps, sync)
        eng = opt._engine
        ask_bucket = eng.max_n
        rng = np.random.default_rng(2000 + seed)

        def tell() -> None:
            cfg = SPACE.sample(rng)
            opt.tell(cfg, objective(cfg))

        tells = _samples(tell, tt_reps, sync)

        def refit() -> None:
            eng._hypers_fresh = False
            eng.ensure_ready()

        refits = _samples(refit, 3 if quick else 5, sync)
        mn, mt = statistics.median(t_np), statistics.median(t_tt)
        res["ask_latency_ms"][str(n)] = {
            "numpy": mn, "torch": mt, "speedup": mn / mt,
            "numpy_mean": statistics.fmean(t_np), "torch_mean": statistics.fmean(t_tt),
            "numpy_samples": t_np, "torch_samples": t_tt,
        }
        # the tells grow the history past n, so tell and refit read at a later bucket
        res["engine"][str(n)] = {"ask_bucket": ask_bucket, "bucket": eng.max_n, "n_after": eng.n,
                                 "first_asks_ms": first,
                                 "tell_ms": statistics.median(tells), "tell_samples": tells,
                                 "refit_ms": statistics.median(refits), "refit_samples": refits}
        print(f"  n={n:4d}  numpy={mn:9.2f} ms   torch={mt:7.3f} ms   speedup={mn / mt:7.1f}x"
              f"   tell={statistics.median(tells):6.3f} ms   refit={statistics.median(refits):7.2f}"
              f" ms   first asks {[round(t, 1) for t in first]} ms")

    # -- mux-wide batched ask: 8 sessions, one program --------------------
    reps = 3 if quick else 10
    for sess_hist in sess_hists:
        seq_opts = [with_history("torch", seed + s, sess_hist, device) for s in range(n_sessions)]
        bat_opts = [with_history("torch", seed + s, sess_hist, device) for s in range(n_sessions)]
        for o in seq_opts:  # capture + hyper-refit warm-up
            o.ask()
        batched = BatchedBayesOpt(bat_opts)
        batched.ask_all()
        s_seq = _samples(lambda: [o.ask() for o in seq_opts], reps, sync)
        s_bat = _samples(batched.ask_all, reps, sync)
        t_seq, t_bat = statistics.median(s_seq), statistics.median(s_bat)
        res["batched"][str(sess_hist)] = {
            "sessions": n_sessions, "history": sess_hist,
            "sequential_ms": t_seq, "batched_ms": t_bat, "speedup": t_seq / t_bat,
            "sequential_samples": s_seq, "batched_samples": s_bat,
        }
        print(f"  {n_sessions} sessions (n={sess_hist}): sequential={t_seq:7.2f} ms"
              f"   batched={t_bat:7.2f} ms   speedup={t_seq / t_bat:5.1f}x")
    after = step_counts()
    res["steps"] = {k: {f: v[f] - steps_before.get(k, {}).get(f, 0) for f in v}
                    for k, v in after.items() if k.startswith("gp.")}
    print("  programs (runs / captures / replays): " + ", ".join(
        f"{k} {v['runs']}/{v['captures']}/{v['replays']}" for k, v in sorted(res["steps"].items())))
    return res


def _write(res: Dict[str, Any], out_dir: Any) -> Dict[str, Any]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "optimizer_throughput.json").write_text(json.dumps(res, indent=1))
    print(f"wrote {out / 'optimizer_throughput.json'}")
    return res


def bench(quick: bool = False, seed: int = 7, *, device: Any = "cuda",
          out_dir: Any = BENCH_ROOT) -> List[Any]:
    """Runner protocol: run, write the JSON, convert to BenchRecords."""
    from ..core.baseline import BenchRecord

    res = _write(run(quick=quick, seed=seed, device=device), out_dir)
    wl = f"d{res['d']}"
    records = []
    for n, row in res["ask_latency_ms"].items():
        for backend in ("numpy", "torch"):
            records.append(BenchRecord.for_component(
                "optimizer_throughput", f"ask_ms/{backend}/n{n}", row[f"{backend}_samples"],
                "optimizer", f"{wl}n{n}", unit="ms", speedup=row["speedup"]))
    for h, row in res["batched"].items():
        records.append(BenchRecord.for_component(
            "optimizer_throughput", f"batched_ms/s{row['sessions']}h{h}",
            row["batched_samples"], "optimizer", f"{wl}s{row['sessions']}h{h}",
            unit="ms", speedup=row["speedup"]))
    return records


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="seconds-scale subset with the same JSON schema")
    ap.add_argument("--seed", type=int, default=7,
                    help="base seed for history generation (reproducible runs)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=str(BENCH_ROOT))
    args = ap.parse_args(argv)
    _write(run(quick=args.quick, seed=args.seed, device=args.device), args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
