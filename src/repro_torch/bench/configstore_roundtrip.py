"""Config-store round trip: per-context tuning that SURVIVES the process.

The twin of the reference's ``benchmarks/configstore_roundtrip.py``.  One
run tunes ``torch_flash_attention`` under two workload signatures (the
reference's (b1, s256) and (b4, s512), h8 k4 d64, float32), promotes both
session bests into a config store keyed by their full context, and a FRESH
interpreter, which imports ``repro_torch`` and nothing of the reference,
resolves each back by context under its own hardware fingerprint (on the
card, the card's).  It also measures what resolution costs: the first
(uncached) lookup and the amortized per-call cost of the cached resolver.

The reference's shapes, budgets (8; quick 4), lookups, seed and ``rs``
sessions are kept.  The tuned space is the component's, less ``kernel`` on
the CPU: a config must never persist with a time taken for another impl,
and a CPU tensor never reaches the kernel.  On the card ``kernel`` stays:
the reference drops ``pallas`` only because interpret mode times nothing
real on a CPU.  The store lives under ``out_dir`` (``configstore/``), so
the twin never writes tuned settings into the repository's default store,
where a served model's prefill could resolve them.  Outputs:
``configstore_resolve.json`` under ``out_dir`` (by default
``results/torch/bench/``).

    PYTHONPATH=src python -m repro_torch.bench.configstore_roundtrip --quick --device cpu
    PYTHONPATH=src python -m repro_torch.bench.configstore_roundtrip       # on the card
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..core import configstore
from ..core.agent import drive_session, make_session, promote_session_report
from ..core.registry import get_component
from ..core.tunable import Categorical, TunableSpace
from ..kernels.flash_attention import ops as attn_ops
from ..launch.microbench import candidate, median_time_us
from . import BENCH_ROOT, require_device
from .kernel_autotune import COMPONENT, inputs

CONTEXT_SHAPES = {
    # workload signature -> concrete call shape (distinct pow2 buckets)
    "small": dict(b=1, s=256, h=8, k=4, d=64),
    "large": dict(b=4, s=512, h=8, k=4, d=64),
}
SRC = Path(__file__).resolve().parents[2]

_RESOLVE_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.core import configstore
from repro_torch.kernels.flash_attention import ops as attn_ops
configstore.set_default_store(configstore.ConfigStore(sys.argv[2]))
out = {"hardware": configstore.hardware_fingerprint(),
       "settings": {wl: attn_ops.attention_settings.settings_for(wl)
                    for wl in json.loads(sys.argv[3])},
       "foreign_modules": sorted({m.split(".")[0] for m in sys.modules} & {"jax", "repro"})}
print(json.dumps(out))
"""


def tuned_space(device: Any) -> TunableSpace:
    """The component's space; ``kernel`` only where it runs (the card)."""
    meta = get_component(COMPONENT)
    impl = meta.space["impl"]
    choices = tuple(c for c in impl.choices
                    if c != "kernel" or torch.device(device).type == "cuda")
    return TunableSpace([Categorical("impl", "unrolled", choices),
                         meta.space["block_q"], meta.space["block_kv"]])


def _measure(shape: Dict[str, int], settings: Dict[str, Any], device: Any) -> Dict[str, float]:
    q, k, v = inputs(shape, device)
    fn = candidate(
        COMPONENT,
        lambda q, kk, vv: attn_ops.flash_attention(
            q, kk, vv, impl=settings["impl"], block_q=settings["block_q"],
            block_kv=settings["block_kv"]),
        settings, attn_ops.workload_signature(shape["b"], shape["s"], shape["s"], shape["d"]))
    return {"time_us": median_time_us(fn, q, k, v)}


def run(budget: int = 8, lookups: int = 20000, seed: int = 17, *, device: Any = "cuda",
        store_root: Any = BENCH_ROOT / "configstore") -> Dict[str, Any]:
    device = require_device(device)
    meta = get_component(COMPONENT)
    store = configstore.ConfigStore(store_root)
    res: Dict[str, Any] = {"contexts": {}, "budget": budget, "seed": seed,
                           "device": str(device), "store": str(store.root)}
    old = configstore.set_default_store(store)
    try:
        # -- tune: one session per workload context, bests promoted to the store
        workloads = {}
        for i, (name, shape) in enumerate(CONTEXT_SHAPES.items()):
            wl = attn_ops.workload_signature(shape["b"], shape["s"], shape["s"], shape["d"])
            workloads[name] = wl
            session = make_session(meta, "time_us", workload=wl, space=tuned_space(device),
                                   optimizer="rs", budget=budget, seed=seed + i)
            core = drive_session(session, lambda s, shape=shape: _measure(shape, s, device))
            report = json.loads(core.session_report().decode())
            if not promote_session_report(store, report):
                raise AssertionError(f"{wl}: promotion refused (no gate is set here)")
            res["contexts"][name] = {"workload": wl, "best_config": report["best_config"],
                                     "best_time_us": report["best_value"]}
            print(f"  tuned {meta.name}@{wl}: {report['best_config']} "
                  f"({report['best_value']:.1f} us over {report['evaluations']} evals)")

        # -- both bests persisted under DISTINCT contexts
        sigs = list(workloads.values())
        if len(set(sigs)) != 2:
            raise AssertionError(f"workload signatures must differ: {sigs}")
        for name, wl in workloads.items():
            entry = store.resolve_entry(configstore.context_for(meta.name, wl))
            if entry is None or entry["context"]["workload"] != wl or \
                    entry["settings"] != res["contexts"][name]["best_config"]:
                raise AssertionError(f"{wl}: stored entry {entry} is not the session's best")

        # -- resolver overhead: uncached store hit vs the cached hot path,
        # both sampled (the baseline gate needs distributions)
        uncached = []
        for _ in range(5):
            configstore.invalidate_cache()
            t0 = time.perf_counter()
            attn_ops.attention_settings.settings_for(sigs[0])
            uncached.append((time.perf_counter() - t0) * 1e3)
        n_chunks = 5
        chunk = max(lookups // n_chunks, 1)
        cached = []
        for _ in range(n_chunks):
            t0 = time.perf_counter()
            for _ in range(chunk):
                attn_ops.attention_settings.settings_for(sigs[0])
            cached.append((time.perf_counter() - t0) / chunk * 1e9)
    finally:
        configstore.set_default_store(old)
    res["resolve"] = {"uncached_first_ms": sorted(uncached)[len(uncached) // 2],
                      "cached_ns_per_lookup": sorted(cached)[len(cached) // 2],
                      "lookups": lookups, "cached_ns_samples": cached,
                      "uncached_ms_samples": uncached}
    print(f"  resolver: first lookup {res['resolve']['uncached_first_ms']:.2f} ms, cached "
          f"{res['resolve']['cached_ns_per_lookup']:.0f} ns/call over {lookups} calls")

    # -- cross-process: a fresh interpreter resolves each context from disk
    child = subprocess.run([sys.executable, "-c", _RESOLVE_CHILD, str(SRC), str(store.root),
                            json.dumps(sigs)], capture_output=True, text=True, timeout=300)
    if child.returncode != 0:
        raise AssertionError(f"the resolve child failed:\n{child.stderr[-2000:]}")
    out = json.loads(child.stdout.strip().splitlines()[-1])
    if out["foreign_modules"]:
        raise AssertionError(f"the resolve child imported {out['foreign_modules']}")
    if out["hardware"] != configstore.hardware_fingerprint():
        raise AssertionError(f"the child resolved under {out['hardware']}, this process is "
                             f"{configstore.hardware_fingerprint()}")
    for name, wl in workloads.items():
        best = res["contexts"][name]["best_config"]
        got = {k: out["settings"][wl][k] for k in best}
        if got != best:
            raise AssertionError(f"{name}: the fresh process resolved {got}, promoted {best}")
    res["fresh_process_resolution"] = "ok"
    res["fresh_process_hardware"] = out["hardware"]
    print(f"  a fresh process resolved both contexts from {store.root} under {out['hardware']}")
    return res


def _write(res: Dict[str, Any], quick: bool, out_dir: Any) -> Dict[str, Any]:
    res["quick"] = quick
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "configstore_resolve.json").write_text(json.dumps(res, indent=1))
    print(f"configstore round-trip OK -> {out / 'configstore_resolve.json'}")
    return res


def _run(quick: bool, seed: int, device: Any, out_dir: Any) -> Dict[str, Any]:
    return _write(run(budget=4 if quick else 8, lookups=5000 if quick else 20000, seed=seed,
                      device=device, store_root=Path(out_dir) / "configstore"), quick, out_dir)


def bench(quick: bool = False, seed: int = 17, *, device: Any = "cuda",
          out_dir: Any = BENCH_ROOT) -> List[Any]:
    """Runner protocol: run, write the JSON, convert to BenchRecords."""
    from ..core.baseline import BenchRecord

    res = _run(quick, seed, device, out_dir)
    return [BenchRecord.for_component("configstore_roundtrip", "cached_ns_per_lookup",
                                      res["resolve"]["cached_ns_samples"], "configstore",
                                      "resolve_hot", unit="ns"),
            BenchRecord.for_component("configstore_roundtrip", "uncached_first_ms",
                                      res["resolve"]["uncached_ms_samples"], "configstore",
                                      "resolve_cold", unit="ms")]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="smoke budget")
    ap.add_argument("--seed", type=int, default=17, help="base session seed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=str(BENCH_ROOT))
    args = ap.parse_args(argv)
    _run(args.quick, args.seed, args.device, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
