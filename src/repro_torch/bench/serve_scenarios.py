"""Traffic-scenario serving benchmark: continuous batching vs gang scheduling.

The twin of the reference's ``benchmarks/serve_scenarios.py`` on the port's
:class:`~repro_torch.runtime.serve_loop.BatchedServer`.  It replays the
seeded traffic mixes of :mod:`repro_torch.runtime.traffic` under both
schedulers and records tokens/s and p50/p99 latency as raw samples.  The
headline claim, continuous batching beats gang scheduling on the heavy-tail
mix, is a ``stats.compare`` verdict over repeated timed replays (mode=max on
tokens/s): gang stalls every admitted batch behind its slowest member and
syncs the host every token, while the continuous engine backfills freed
slots mid-flight and syncs once per ``sync_interval``.

The reference's scenario seeds, settings, request counts and the equality
of the two schedulers' token totals are kept.  Added: the served ``model``
(at full width on the card, reduced on the CPU: :func:`.load_model`), the
``device``, the ``capacity``, which ``scenarios`` run, the ``repeats`` per
mode, and one untimed warm-up
replay per mode before the timed ones (on the card the first replay pays
cuBLAS and allocator set-up).  Scheduler settings are pinned through
``BatchedServer(settings=...)``, so the comparison measures the scheduler,
not whatever the config store holds.  On the card a replay's tokens/s covers
the device's work: the last sync's host fetch waits for it.

    PYTHONPATH=src python -m repro_torch.bench.serve_scenarios --quick --device cpu
    PYTHONPATH=src python -m repro_torch.bench.serve_scenarios \\
        --capacity 2048 --scenarios heavy_tail --repeats 5            # on the card
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from ..core import stats
from ..runtime import traffic
from ..runtime.serve_loop import COMPONENT, BatchedServer, workload_signature
from . import BENCH_ROOT, load_model

CAPACITY = 128
MAX_BATCH = 4
# per-scenario seed offsets: mixes stay distinct under one --seed
SCENARIO_SEEDS = {"diurnal": 11, "bursts": 13, "heavy_tail": 17}
SETTINGS = dict(max_batch=MAX_BATCH, admission=4, prefill_chunk=64,
                sync_interval=4, max_new_tokens=32)


def _server(params, cfg, mode: str, capacity: int, device) -> BatchedServer:
    return BatchedServer(params, cfg, capacity=capacity, eos_id=-1, mode=mode,
                         settings=dict(SETTINGS), device=device)


def scenario_arrivals(seed: int, quick: bool) -> Dict[str, List[traffic.Arrival]]:
    n = 12 if quick else 20
    # long_max stays <= CAPACITY - max prompt width (64): neither scheduler
    # clips any budget, so both modes serve the exact same token totals
    return {
        "diurnal": traffic.diurnal(seed + SCENARIO_SEEDS["diurnal"], n=n),
        "bursts": traffic.bursts(seed + SCENARIO_SEEDS["bursts"], n=n,
                                 burst_size=5),
        "heavy_tail": traffic.heavy_tail(seed + SCENARIO_SEEDS["heavy_tail"],
                                         n=n, p_long=0.25,
                                         long_max=48 if quick else 64),
    }


def run(quick: bool = False, seed: int = 7, *, model: str = "olmo-1b",
        device: Any = "cuda", capacity: int = CAPACITY,
        scenarios: Optional[Sequence[str]] = None, repeats: Optional[int] = None,
        out_dir: Any = BENCH_ROOT) -> Dict[str, Any]:
    """Replay each scenario ``repeats`` times per scheduler after one
    untimed warm-up replay per scheduler; write ``serve_scenarios.json``
    under ``out_dir`` and return the same dict."""
    params, cfg = load_model(model, device=device, seed=seed)
    repeats = repeats if repeats is not None else (6 if quick else 8)
    arrivals = scenario_arrivals(seed, quick)
    names = list(scenarios) if scenarios is not None else list(arrivals)
    unknown = [n for n in names if n not in arrivals]
    if unknown or not names:
        raise ValueError(f"unknown scenarios {unknown}; choose from {list(arrivals)}")

    t0 = time.time()
    for mode in ("gang", "continuous"):                     # untimed warm-up
        traffic.replay(_server(params, cfg, mode, capacity, device), arrivals[names[0]])
    res: Dict[str, Any] = {"quick": quick, "seed": seed, "repeats": repeats,
                           "model": cfg.name, "n_layers": cfg.n_layers,
                           "d_model": cfg.d_model, "device": str(device),
                           "capacity": capacity, "settings": dict(SETTINGS),
                           "workload": workload_signature(cfg.family, capacity),
                           "warmup_replays": 2, "scenarios": {}, "wall_s": 0.0}
    for name in names:
        arr = arrivals[name]
        # diurnal replays paced (open-loop: arrivals land on schedule);
        # bursts/heavy_tail replay as offered drains (deterministic timing)
        speed = 8.0 if name == "diurnal" else 0.0
        row: Dict[str, Any] = {"n_requests": len(arr), "speed": speed}
        for mode in ("gang", "continuous"):
            tps, p50, p99, toks = [], [], [], None
            for _ in range(repeats):
                m = traffic.replay(_server(params, cfg, mode, capacity, device), arr, speed=speed)
                tps.append(m["tokens_per_s"])
                p50.append(m["p50_latency_s"])
                p99.append(m["p99_latency_s"])
                toks = m["total_tokens"]
            row[mode] = {"tokens_per_s": tps, "p50_latency_s": p50,
                         "p99_latency_s": p99, "total_tokens": toks}
        # same offered work on both sides, or the throughput A/B is bogus
        if row["gang"]["total_tokens"] != row["continuous"]["total_tokens"]:
            raise AssertionError(f"{name}: gang served {row['gang']['total_tokens']} tokens, "
                                 f"continuous {row['continuous']['total_tokens']}")
        res["scenarios"][name] = row

    if "heavy_tail" in res["scenarios"]:
        ht = res["scenarios"]["heavy_tail"]
        res["heavy_tail_verdict"] = stats.compare(
            ht["gang"]["tokens_per_s"], ht["continuous"]["tokens_per_s"],
            mode="max", seed=seed).to_dict()
    res["wall_s"] = time.time() - t0

    for name, row in res["scenarios"].items():
        g, c = row["gang"], row["continuous"]
        print(f"  {name:11s} gang {stats.median(g['tokens_per_s']):8.1f} tok/s "
              f"p99 {stats.median(g['p99_latency_s']):.3f}s │ continuous "
              f"{stats.median(c['tokens_per_s']):8.1f} tok/s "
              f"p99 {stats.median(c['p99_latency_s']):.3f}s")
    if "heavy_tail_verdict" in res:
        v = res["heavy_tail_verdict"]
        print(f"  heavy_tail continuous-vs-gang verdict: {v['verdict']} "
              f"(effect {v['effect']:+.1%}, p={v['p_value']})")

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "serve_scenarios.json").write_text(json.dumps(res, indent=1))
    return res


def bench(quick: bool = False, seed: int = 7, **run_kw: Any) -> list:
    """Runner protocol: raw tokens/s and tail-latency samples per scenario
    for the continuous engine (the deployed scheduler), with the
    continuous-vs-gang verdict riding the heavy-tail record's meta."""
    from ..core.baseline import BenchRecord

    res = run(quick=quick, seed=seed, **run_kw)
    wl = res["workload"]
    recs = []
    for name, row in res["scenarios"].items():
        meta: Dict[str, Any] = {"n_requests": row["n_requests"],
                                "gang_tokens_per_s": stats.median(row["gang"]["tokens_per_s"])}
        if name == "heavy_tail":
            meta["vs_gang"] = res["heavy_tail_verdict"]
        recs.append(BenchRecord.for_component(
            "serve_scenarios", f"{name}_tokens_per_s",
            row["continuous"]["tokens_per_s"], COMPONENT, wl,
            mode="max", unit="tok/s", **meta))
    ht = res["scenarios"]["heavy_tail"]
    recs.append(BenchRecord.for_component(
        "serve_scenarios", "heavy_tail_p99_latency_s",
        ht["continuous"]["p99_latency_s"], COMPONENT, wl,
        mode="min", unit="s", n_requests=ht["n_requests"]))
    return recs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--model", default="olmo-1b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--capacity", type=int, default=CAPACITY)
    ap.add_argument("--scenarios", default=None,
                    help=f"comma-separated subset of {list(SCENARIO_SEEDS)}")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--out-dir", default=str(BENCH_ROOT))
    args = ap.parse_args(argv)
    res = run(quick=args.quick, seed=args.seed, model=args.model, device=args.device,
              capacity=args.capacity,
              scenarios=args.scenarios.split(",") if args.scenarios else None,
              repeats=args.repeats, out_dir=args.out_dir)
    # the CLI agrees with check.py: the headline claim must be a verdict
    v = res.get("heavy_tail_verdict") or {}
    return 0 if v.get("verdict") == "improved" else 1


if __name__ == "__main__":
    sys.exit(main())
