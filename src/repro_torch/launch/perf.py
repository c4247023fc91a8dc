"""Perf hillclimb driver: hypothesis → change → re-trace → validate, logged.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch olmo-1b --shape train_4k

The port of ``repro/launch/perf.py``.  For a chosen cell this runs a
scripted sequence of MLOS-tunable overrides (each with an explicit
hypothesis and napkin prediction recorded BEFORE the measurement), compares
the step bound against the running best through the ``core.stats`` A/B
comparator (``improved | regressed | noise``), keeps what wins, and stops
after ``patience`` consecutive non-``improved`` verdicts.  Each experiment
is a fresh subprocess of the port's dry-run (``repro_torch.launch.dryrun``)
writing a tagged result file; this driver only orchestrates and
summarizes.  The candidates and their ranking are the reference's under
the port's component names; the memory gate is the card's memory, on every
mesh (on ``single`` and ``multi`` each device is an H100, the bound rank
0's, :mod:`.dryrun`).  The
winners persist under the cell as the workload context and under the
card's fingerprint from :data:`.mesh.HW`, wherever the hillclimb ran: the
bound is the card's, so a tuned entry for the card is never filed under
the host's ``cpu:`` fingerprint.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..core import configstore, stats
from .dryrun import OUT_DIR
from .mesh import HW
from .tuning import parse_override, split_target

__all__ = ["CANDIDATES", "REL_TOL", "hillclimb", "persist_best", "PERF_DIR"]

SRC = Path(__file__).resolve().parents[2]
PERF_DIR = SRC.parent / "results" / "torch" / "perf"

# A candidate must cut the step bound by at least this relative margin for
# the comparator to call it "improved" (anything smaller is modeling noise —
# the analytic roofline carries single-digit-% error by construction).
REL_TOL = 0.05

# Candidate moves.  `predict` is the napkin estimate (recorded verbatim in the
# log, then marked confirmed/refuted against the measurement).
CANDIDATES: List[Dict[str, Any]] = [
    dict(name="kernel-flash",
         sets=["torch_flash_attention.impl=kernel"],
         hypothesis="the flash kernel keeps (Sq×Skv) scores in shared memory; device "
                    "memory traffic falls to the Q, K, V, O tiles",
         predict="memory_s: large drop on attention-heavy cells (2-10x of the "
                 "attention share); compute_s/collective_s unchanged"),
    dict(name="remat-dots",
         sets=["torch_layer_stack.remat=dots"],
         hypothesis="a dots checkpoint keeps the matmul outputs, skipping their "
                    "forward recompute in the backward",
         predict="compute_s: -15..25% on train cells (8·N·D → ~6·N·D); "
                 "per-device memory rises (saved dots)"),
    dict(name="remat-none",
         sets=["torch_layer_stack.remat=none"],
         hypothesis="no recompute at all — lowest FLOPs, highest memory",
         predict="compute_s: -25% vs full; memory may exceed the card on big archs"),
    dict(name="capacity-1.0",
         sets=["torch_moe_dispatch.capacity_factor=1.0"],
         hypothesis="perfectly-balanced capacity: 20% fewer expert-FFN slots "
                    "(tokens dropped instead of padded)",
         predict="compute_s: -10..20% on MoE cells; risk: drops hurt quality "
                 "(recorded, not modeled here)"),
    dict(name="block-q-128",
         sets=["torch_flash_attention.block_q=128"],
         hypothesis="fewer Q blocks → fewer mask/softmax fixed costs and larger "
                    "products",
         predict="compute_s/memory_s: few-% drop"),
    dict(name="loss-chunk-512",
         sets=["torch_layer_stack.loss_chunk=512"],
         hypothesis="smaller CE chunks shrink live logits (B,chunk,V)",
         predict="memory: drops for 256k-vocab archs; bytes roughly flat"),
    dict(name="microbatch-8", microbatches=8, sets=[],
         hypothesis="8 µbatches cut live activations ~8x at the cost of "
                    "8x weight regathers",
         predict="memory: large drop; collective_s: up on FSDP cells"),
    dict(name="microbatch-1", microbatches=1, sets=[],
         hypothesis="no accumulation: one weight gather per step",
         predict="collective_s: down vs µ>1; live activations up"),
]

# which candidate to try first against each dominant term
ORDER = {"memory_s": ["kernel-flash", "microbatch-8", "loss-chunk-512", "remat-dots",
                      "block-q-128", "capacity-1.0", "remat-none", "microbatch-1"],
         "compute_s": ["remat-dots", "remat-none", "capacity-1.0", "kernel-flash",
                       "block-q-128", "loss-chunk-512", "microbatch-1", "microbatch-8"],
         "collective_s": ["microbatch-1", "capacity-1.0", "remat-dots", "kernel-flash",
                          "block-q-128", "loss-chunk-512", "microbatch-8", "remat-none"]}


def _dryrun(arch: str, shape: str, mesh: str, tag: str, sets: List[str],
            microbatches: Optional[int], out: str, store: Optional[str] = None
            ) -> Dict[str, Any]:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", str(out)]
    if tag:  # baseline reuses the sweep's cached cell; experiments recompute
        cmd += ["--tag", tag, "--force"]
    for s in sets:
        cmd += ["--set", s]
    if microbatches:
        cmd += ["--microbatches", str(microbatches)]
    if store:
        cmd += ["--store", str(store)]
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": str(SRC) + (os.pathsep + path if path else "")}
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=5400, env=env)
    suffix = f"{mesh}__{tag}" if tag else mesh
    result = Path(out) / f"{arch}__{shape}__{suffix}.json"
    if not result.exists():
        raise RuntimeError(f"dryrun produced no result: {r.stdout[-500:]} {r.stderr[-1000:]}")
    return json.loads(result.read_text())


def _terms(rec: Dict[str, Any]) -> Dict[str, float]:
    return rec["roofline"]


def persist_best(arch: str, shape: str, mesh: str, best_sets: List[str],
                 summary: Dict[str, Any], store: Optional[configstore.ConfigStore] = None
                 ) -> List[str]:
    """Persist the cell's winning overrides into the config store, keyed by
    the cell as the workload context and by the card's fingerprint
    (:data:`.mesh.HW`), so the next launch of this cell on the card
    resolves them instead of re-deriving.  Returns the contexts written."""
    if not best_sets:
        return []
    store = store or configstore.default_store()
    cell = f"{arch}/{shape}/{mesh}"
    merged: Dict[tuple, Dict[str, Any]] = {}
    for s in best_sets:
        for target, kv in parse_override(s).items():
            comp, wl = split_target(target)
            # Context-targeted sets keep their own workload key; plain global
            # sets are filed under the cell they were tuned in.
            merged.setdefault((comp, wl or cell), {}).update(kv)
    written = []
    for (comp, wl), kv in merged.items():
        if comp == "optimizer":
            continue  # process default, not a component config
        ctx = configstore.Context(comp, wl, HW["fingerprint"], configstore.sw_fingerprint())
        store.put(ctx, kv, provenance={"source": "perf.hillclimb", "cell": cell,
                                       "speedup_step_bound": summary["speedup_step_bound"]})
        written.append(f"{comp}@{wl}")
    return written


def hillclimb(arch: str, shape: str, mesh: str = "one", out: str = str(OUT_DIR),
              patience: int = 3, log_path: Optional[str] = None,
              store: Optional[str] = None) -> Dict[str, Any]:
    """``store``: the config store's root for the experiments' redeploy and
    the winners (default: the process's default store)."""
    store_obj = configstore.ConfigStore(store) if store else configstore.default_store()
    log: List[Dict[str, Any]] = []
    base = _dryrun(arch, shape, mesh, "", [], None, out, store)
    if base["status"] != "ok":
        raise RuntimeError(f"baseline failed: {base.get('error')}")
    best = base
    best_sets: List[str] = []
    best_mb: Optional[int] = None
    print(f"baseline {arch}/{shape}/{mesh}: {_fmt(base)}")
    log.append({"iter": 0, "name": "baseline(paper-faithful defaults)",
                "sets": [], "terms": _terms(base),
                "dominant": base["bottleneck"],
                "roofline_fraction": base.get("roofline_fraction"),
                "per_device_bytes": base["per_device_bytes"]})

    stall = 0
    tried: set = set()
    it = 0
    while stall < patience:
        # pick the untried candidate most likely to cut the CURRENT dominant term
        order = ORDER[best["bottleneck"]]
        ranked = [c for c in CANDIDATES if c["name"] not in tried]
        if not ranked:
            break
        ranked.sort(key=lambda c: order.index(c["name"]) if c["name"] in order else 99)
        cand = ranked[0]
        tried.add(cand["name"])
        it += 1
        sets = best_sets + cand.get("sets", [])
        mb = cand.get("microbatches", best_mb)
        print(f"[{it}] trying {cand['name']} (hypothesis: {cand['hypothesis'][:60]}…)")
        try:
            rec = _dryrun(arch, shape, mesh, f"hc{it}", sets, mb, out, store)
        except (RuntimeError, OSError, subprocess.SubprocessError, ValueError) as e:
            rec = {"status": "error", "error": str(e)}
        entry = {"iter": it, "name": cand["name"], "sets": sets, "microbatches": mb,
                 "hypothesis": cand["hypothesis"], "predict": cand["predict"]}
        if rec.get("status") != "ok":
            entry["outcome"] = f"ERROR: {rec.get('error', '?')[:200]}"
            stall += 1
        else:
            before = _terms(best)[best["bottleneck"]]
            after_terms = _terms(rec)
            after = after_terms[best["bottleneck"]]
            gain = (before - after) / before if before else 0.0
            # keep/revert through the core.stats comparator: analytic bounds are
            # singleton samples, so the verdict is its effect-size-only form
            cmp = stats.compare([max(_terms(best).values())],
                                [max(after_terms.values())],
                                min_effect=REL_TOL, mode="min")
            entry.update({"terms": after_terms, "dominant": rec["bottleneck"],
                          "per_device_bytes": rec["per_device_bytes"],
                          "roofline_fraction": rec.get("roofline_fraction"),
                          "gain_on_prev_dominant": gain,
                          "verdict": cmp.verdict,
                          "effect_on_step_bound": cmp.effect,
                          "fits": rec["fits"]})
            # keep any strict win that fits the card; only a confident
            # ("improved", i.e. beyond REL_TOL) win resets patience
            better = cmp.effect < 0 and rec["per_device_bytes"] < HW["memory_bytes"]
            entry["outcome"] = (f"confirmed[{cmp.verdict}]: dominant {best['bottleneck']} "
                                f"{before*1e3:.1f}→{after*1e3:.1f} ms ({gain:+.1%})"
                                if better else
                                f"refuted/kept-out[{cmp.verdict}]: step bound "
                                f"{max(_terms(best).values())*1e3:.1f}→"
                                f"{max(after_terms.values())*1e3:.1f} ms")
            if better:
                best, best_sets, best_mb = rec, sets, mb
                stall = 0 if cmp.verdict == "improved" else stall + 1
            else:
                stall += 1
        print(f"    {entry['outcome']}")
        log.append(entry)

    summary = {
        "cell": f"{arch}/{shape}/{mesh}",
        "hw": HW["fingerprint"],
        "baseline": {"terms": _terms(base), "dominant": base["bottleneck"],
                     "roofline_fraction": base.get("roofline_fraction"),
                     "per_device_bytes": base["per_device_bytes"]},
        "best": {"terms": _terms(best), "dominant": best["bottleneck"],
                 "roofline_fraction": best.get("roofline_fraction"),
                 "per_device_bytes": best["per_device_bytes"],
                 "sets": best_sets, "microbatches": best_mb},
        "speedup_step_bound": max(_terms(base).values()) / max(_terms(best).values()),
        "log": log,
    }
    summary["persisted_contexts"] = persist_best(arch, shape, mesh, best_sets, summary,
                                                 store_obj)
    lp = Path(log_path or PERF_DIR / f"{arch}__{shape}__{mesh}.json")
    lp.parent.mkdir(parents=True, exist_ok=True)
    lp.write_text(json.dumps(summary, indent=1))
    print(f"\nstep bound {max(_terms(base).values())*1e3:.1f} → "
          f"{max(_terms(best).values())*1e3:.1f} ms "
          f"({summary['speedup_step_bound']:.2f}x); log → {lp}")
    if summary["persisted_contexts"]:
        print(f"persisted tuned configs under {HW['fingerprint']} → {store_obj.root} "
              f"({', '.join(summary['persisted_contexts'])})")
    return summary


def _fmt(rec: Dict[str, Any]) -> str:
    r = rec["roofline"]
    return (f"compute={r['compute_s']*1e3:.1f}ms memory={r['memory_s']*1e3:.1f}ms "
            f"coll={r['collective_s']*1e3:.1f}ms bound={rec['bottleneck']} "
            f"frac={rec.get('roofline_fraction', 0):.4f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="one")
    ap.add_argument("--patience", type=int, default=3)
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--store", default=None, help="config store root (default: the repo's)")
    ap.add_argument("--log", default=None)
    args = ap.parse_args()
    hillclimb(args.arch, args.shape, args.mesh, out=args.out, patience=args.patience,
              log_path=args.log, store=args.store)


if __name__ == "__main__":
    main()
