"""Multi-instance tuning: one agent daemon against one daemon per instance.

The twin of the reference's ``benchmarks/multi_instance.py``.  The paper's
production claim (§2.1) is *instance-level* tuning at scale: one MLOS agent
side-car drives a custom optimization per live component instance.  This
tunes N hash-table instances (the port's ``torch_hashtable``; distinct
workloads, so distinct optima) two ways:

  * **baseline**: N sequential single-session runs in this process (the
    one-daemon-per-instance shape),
  * **multiplexed**: ONE spawned :class:`~repro_torch.core.agent.AgentProcess`
    hosting all N sessions over ONE shared-memory channel, telemetry
    demuxed by instance id.

The objective is ``collisions`` (deterministic given the workload seed), so
the multiplexed bests must match the baselines exactly, value and config
(``identical``); the wall-clock lines
are context only (the baseline has no spawn, channel or poll sleeps).  The
reference's instances, budget (16; quick 6), seeds and ``rs`` optimizer are
kept.  ``optimizer="bo_torch"`` runs the sessions on the torch GP engine on
``device`` (the card unless the caller asks for the CPU): the run sets it as
the process's optimizer default, which the spawned daemon inherits, and the
daemon's mux then prices every ready session in one batched ask.
Outputs: ``multi_instance.json`` under ``out_dir`` (by default
``results/torch/bench/``).

    PYTHONPATH=src python -m repro_torch.bench.multi_instance
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from ..core.agent import AgentClient, AgentProcess, TrackedInstance, drive_session, make_session
from ..core.channel import MlosChannel
from ..core.codegen import pack_telemetry
from ..core.optimizers import optimizer_defaults, set_optimizer_defaults
from ..core.registry import get_component
from ..core.smartcomponents import TunableHashTable, hashtable_workload
from . import BENCH_ROOT

COMPONENT = "torch_hashtable"
INSTANCES = {
    0: dict(name="OpenRowSet", n_keys=3000, lookup_ratio=4.0, skew=0.0, seed=1),
    1: dict(name="BufferManager", n_keys=3000, lookup_ratio=4.0, skew=1.2, seed=2),
    2: dict(name="SessionCache", n_keys=1200, lookup_ratio=1.5, skew=0.5, seed=3),
    3: dict(name="LockTable", n_keys=600, lookup_ratio=8.0, skew=0.0, seed=4),
}
BUDGET = 16
OPTIMIZER = "rs"


def _measure(table: TunableHashTable, iid: int) -> Dict[str, float]:
    wl = {k: v for k, v in INSTANCES[iid].items() if k != "name"}
    return hashtable_workload(table, **wl)


def _sessions(budget: int, seed: int, optimizer: str):
    meta = get_component(COMPONENT)
    return [make_session(meta, "collisions", optimizer=optimizer, budget=budget,
                         seed=seed + iid, instance_id=iid) for iid in INSTANCES]


def run_baseline(budget: int = BUDGET, seed: int = 100,
                 optimizer: str = OPTIMIZER) -> Dict[int, Tuple[float, Dict[str, Any]]]:
    """One agent run per instance, sequentially, in this process: the
    (best value, best config) of each instance."""
    best: Dict[int, Tuple[float, Dict[str, Any]]] = {}
    for s in _sessions(budget, seed, optimizer):
        table = TunableHashTable()

        def measure(settings: Dict[str, Any], table=table, iid=s.instance_id) -> Dict[str, float]:
            table.apply_and_rebuild(settings)
            return _measure(table, iid)

        obs = drive_session(s, measure).opt.best
        best[s.instance_id] = (obs.value, obs.config)
    return best


def run_multiplexed(budget: int = BUDGET, seed: int = 100, optimizer: str = OPTIMIZER,
                    deadline_s: float = 120.0) -> Dict[int, Dict[str, Any]]:
    """All instances behind one AgentProcess and one MlosChannel; the
    daemon's session reports by instance."""
    meta = get_component(COMPONENT)
    chan = MlosChannel.create(capacity=1 << 16)
    try:
        agent = AgentProcess(chan, _sessions(budget, seed, optimizer)).start()
        client = AgentClient(chan)
        tracked = {iid: TrackedInstance(TunableHashTable()) for iid in INSTANCES}
        for iid, t in tracked.items():
            client.register(COMPONENT, t, instance_id=iid)
        deadline = time.time() + deadline_s
        while len(client.reports) < len(INSTANCES) and time.time() < deadline:
            client.poll(wait_s=0.002, deadline_s=5.0)
            for iid, t in tracked.items():
                if t.dirty:
                    t.dirty = False
                    chan.telemetry.push(pack_telemetry(meta, iid, _measure(t.instance, iid)))
        agent.stop()
        return {iid: client.report_for(COMPONENT, iid) or {} for iid in INSTANCES}
    finally:
        chan.close()


def run(budget: int = BUDGET, seed: int = 100, quick: bool = False, *,
        optimizer: str = OPTIMIZER, device: Any = "cuda",
        out_dir: Any = BENCH_ROOT) -> Dict[str, Any]:
    if quick:
        budget = min(budget, 6)
    old = optimizer_defaults()
    set_optimizer_defaults(device=str(device))
    try:
        t0 = time.time()
        baseline = run_baseline(budget, seed, optimizer)
        t_base = time.time() - t0
        t0 = time.time()
        mux = run_multiplexed(budget, seed, optimizer)
        t_mux = time.time() - t0
    finally:
        set_optimizer_defaults(**old)
    res: Dict[str, Any] = {"budget": budget, "optimizer": optimizer, "quick": quick,
                           "seed": seed, "baseline_wall_s": t_base,
                           "multiplexed_wall_s": t_mux, "instances": {}}
    print(f"multi-instance tuning: {len(INSTANCES)} hash-table instances, budget "
          f"{budget}/instance, {optimizer}, one agent daemon vs {len(INSTANCES)}")
    print(f"  wall: in-process baseline={t_base:.1f}s (no daemon/channel: a floor)  "
          f"multiplexed daemon={t_mux:.1f}s (incl. the spawn)")
    for iid, wl in INSTANCES.items():
        rep, (b, b_config) = mux[iid], baseline[iid]
        b_config = json.loads(json.dumps(b_config))     # as the daemon's report carries it
        m = rep.get("best_value")
        ok = m is not None and m <= b
        res["instances"][wl["name"]] = {
            "baseline_best": b, "multiplexed_best": m,
            "identical": m == b and rep.get("best_config") == b_config,
            "evaluations": rep.get("evaluations"), "no_worse": ok,
            "best_config": rep.get("best_config"), "baseline_config": b_config,
        }
        print(f"  {wl['name']:14s} baseline={b:10.0f}  multiplexed="
              f"{m if m is not None else float('nan'):10.0f}  evals={rep.get('evaluations')}"
              f"  {'OK' if ok else 'WORSE'}")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "multi_instance.json").write_text(json.dumps(res, indent=1))
    return res


def bench(quick: bool = False, seed: int = 100, *, device: Any = "cuda",
          out_dir: Any = BENCH_ROOT) -> List[Any]:
    """Runner protocol: run, then the multiplexed wall clock once more so the
    record carries two samples (a singleton can never reach significance).
    The reference's ``rs`` sessions touch no device."""
    from ..core.baseline import BenchRecord

    res = run(seed=seed, quick=quick, device=device, out_dir=out_dir)
    t0 = time.time()
    run_multiplexed(res["budget"], seed)
    wall2 = time.time() - t0
    no_worse = sum(1 for v in res["instances"].values() if v["no_worse"])
    return [BenchRecord.for_component(
        "multi_instance", "multiplexed_wall_s", [res["multiplexed_wall_s"], wall2],
        "agent", f"hashtable_x{len(res['instances'])}b{res['budget']}",
        unit="s", no_worse=no_worse, instances=len(res["instances"]))]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="budget 6")
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--out-dir", default=str(BENCH_ROOT))
    args = ap.parse_args(argv)
    run(seed=args.seed, quick=args.quick, out_dir=args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
