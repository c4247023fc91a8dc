"""Campaign quickstart: tune a component x workload grid in one shot.

The twin of the reference's ``examples/campaign_quickstart.py``.  Where
:mod:`.autotune_kernels` tunes ONE context with a side-car agent, a
campaign fans a whole grid out through one in-process mux, promotes each
cell's gated best into the config store, and journals everything so a
killed run resumes where it left off.  This example:

  1. tunes 3 hash-table workloads (the port's ``torch_hashtable``; 2 sizes
     x 2 lookup ratios) cold,
  2. re-runs the same campaign id: everything resumes, nothing is measured,
  3. tunes a NEW neighbouring workload, n4096l2, which warm-starts from the
     nearest stored context; the same cell run cold (a store of its own,
     no warm start) says how many evaluations the warm start saved.

The objective (collisions) is deterministic.  The BO cells run on the
port's float64 GP engine on ``--device`` (the card unless ``--device cpu``
is given).  The store and the journals go under ``results/torch/``
(``--store``, ``--journal-root``); entries are filed under this process's
hardware fingerprint.

    PYTHONPATH=src python -m repro_torch.examples.campaign_quickstart             # on the card
    PYTHONPATH=src python -m repro_torch.examples.campaign_quickstart --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict, List, Optional

from ..bench import require_device
from ..core import smartcomponents as _smart  # noqa: F401 — registers torch_hashtable
from ..core.campaign import Campaign, CampaignCell, CellResult, evals_to_reach
from ..core.configstore import ConfigStore, _sig_fields
from ..core.optimizers import optimizer_defaults, set_optimizer_defaults
from ..core.smartcomponents import TunableHashTable, hashtable_workload
from . import RESULTS

GRID = ["n1024l2", "n2048l2", "n2048l4"]
NEIGHBOUR = "n4096l2"
BUDGET = 10
TOL = 0.10


def measure(cell: CampaignCell, settings: Dict[str, Any]) -> Dict[str, float]:
    """One evaluation: build the table with the proposed settings and run the
    cell's workload (the signature's fields name the key count and the
    lookup ratio)."""
    f = _sig_fields(cell.workload)
    table = TunableHashTable(**settings)
    return hashtable_workload(table, n_keys=f["n"], lookup_ratio=float(f["l"]), seed=cell.seed)


def cells_for(workloads: List[str]) -> List[CampaignCell]:
    return [CampaignCell("torch_hashtable", wl, "collisions", optimizer="bo", budget=BUDGET,
                         seed=i) for i, wl in enumerate(workloads)]


def show(results: Dict[str, CellResult]) -> None:
    for cid, r in sorted(results.items()):
        src = f"warm ← {r.warm_start['source_workload']}" if r.warm_start else "cold"
        state = "resumed" if r.resumed else ("promoted" if r.promoted else "rejected")
        print(f"  {cid:28s} best={r.best_value:8.0f} collisions  evals={r.evaluations:2d}  "
              f"{src:16s} {state}")


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="the GP engine's device: cuda or cpu")
    ap.add_argument("--store", default=str(RESULTS / "configstore"))
    ap.add_argument("--journal-root", default=str(RESULTS / "campaign"))
    args = ap.parse_args(argv)
    device = require_device(args.device)
    store = ConfigStore(root=args.store)
    old = optimizer_defaults()
    set_optimizer_defaults(backend="torch", device=str(device))
    try:
        print(f"1) cold campaign over {len(GRID)} workloads (BO on the GP engine, {device}):")
        camp = Campaign(cells_for(GRID), measure, campaign_id="quickstart", store=store,
                        journal_root=args.journal_root)
        first = camp.run()
        show(first)

        print("2) same id again — journal resume, zero measurements:")
        camp2 = Campaign(cells_for(GRID), measure, campaign_id="quickstart", store=store,
                         journal_root=args.journal_root)
        show(camp2.run())
        print(f"   measure() calls during resume: {camp2.measure_calls}")

        print(f"3) new neighbouring workload {NEIGHBOUR} — warm-started from the store:")
        warm = Campaign(cells_for([NEIGHBOUR]), measure, campaign_id="quickstart-2",
                        store=store, journal_root=args.journal_root).run()
        show(warm)
        with tempfile.TemporaryDirectory(prefix="campaign_quickstart_cold_") as td:
            cold = Campaign(cells_for([NEIGHBOUR]), measure, campaign_id="quickstart-2-cold",
                            store=ConfigStore(root=td), journal_root=td,
                            warm_start=False).run()
    finally:
        set_optimizer_defaults(**old)
    w, c = warm[f"torch_hashtable@{NEIGHBOUR}"], cold[f"torch_hashtable@{NEIGHBOUR}"]
    target = min(w.best_value, c.best_value)
    warm_evals = evals_to_reach(w.values, target, tol=TOL)
    cold_evals = evals_to_reach(c.values, target, tol=TOL)
    prior = w.warm_start or {}
    print(f"   within {TOL:.0%} of the best either found ({target:.0f}) after {warm_evals} "
          f"evals warm against {cold_evals} cold (prior: {prior.get('n_prior')} observations, "
          f"{prior.get('distance', float('nan')):.0f} bucket steps away)")
    return {"first": {k: r.promoted for k, r in first.items()},
            "resume_measure_calls": camp2.measure_calls, "warm_start": w.warm_start,
            "warm_values": w.values, "cold_values": c.values, "target": target,
            "warm_evals": warm_evals, "cold_evals": cold_evals, "store": str(store.root),
            "device": str(device)}


if __name__ == "__main__":
    main()
