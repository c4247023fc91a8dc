"""Fault-injected training: exact recovery, recovery time, checkpoint overhead.

The twin of the reference's ``benchmarks/fault_tolerance.py`` over the
port's training runtime.  Its four claims, each measured:

  1. **Kill → resume is exact.**  A supervisor (``chaos.respawn``) runs a
     training child that SIGKILLs itself at chaos-scheduled steps (fire-once
     journal, so a resumed run passes the kill step).  The surviving loss
     trajectory — including steps re-executed after each resume — must be
     bit-identical to an uninterrupted reference child on the same device.
  2. **Completed campaign work is never re-measured.**  A campaign child is
     killed after its first cell completes; the resumed campaign (same id)
     appends zero eval rows for any cell that finished before the kill.
  3. **Torn checkpoints degrade, not die.**  Corrupting the newest
     checkpoint makes restore fall back one step.
  4. **Async checkpointing earns its complexity.**  Train-loop blocked time
     under ``mode=async`` vs ``mode=blocking`` goes through ``stats.compare``
     — the headline verdict must be ``improved``.

The model is reduced OLMo-1B on both devices, as in the reference: float32
on the CPU, bf16 on the card (the dtype training runs in, so the kernels
run their tensor-core path).  The reference's step counts, batch, sequence,
interval, kill schedule and repetitions are kept.  Children are fresh
interpreters (``python -m repro_torch.bench.fault_tolerance --child ...``)
on the same device, started with ``CUBLAS_WORKSPACE_CONFIG`` set, as a
deterministic cuBLAS wants it before the CUDA context exists.  Outputs:
``fault_tolerance.json`` and the campaign child's journal under
``out_dir`` (by default ``results/torch/bench/``).

    PYTHONPATH=src python -m repro_torch.bench.fault_tolerance --quick --device cpu
    PYTHONPATH=src python -m repro_torch.bench.fault_tolerance --quick        # on the card

Child modes (internal): ``--child train`` / ``--child campaign``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..core import stats
from ..launch.campaign import GRIDS, train_config
from . import BENCH_ROOT, require_device

KILL_EXTRA_STEPS = 2   # kill steps land in [1, n_steps - KILL_EXTRA_STEPS)
SRC = Path(__file__).resolve().parents[2]
CHILD_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def _train_params(quick: bool) -> Dict[str, int]:
    return {"n_steps": 10 if quick else 16, "global_batch": 2, "seq_len": 32,
            "ckpt_every": 2}


def _n_kills(quick: bool) -> int:
    return 2 if quick else 3


# -- children -----------------------------------------------------------------
def _child_train(d: Path, seed: int, quick: bool, plan_json: str, device: str) -> int:
    t_start = time.perf_counter()
    from ..runtime.chaos import ChaosInjector, plan_from_json
    from ..runtime.checkpoint import latest_step
    from ..runtime.train_loop import run_training

    p = _train_params(quick)
    chaos = (ChaosInjector(plan_from_json(plan_json),
                           journal=str(d / "chaos.jsonl")) if plan_json else None)
    ckpt_dir = str(d / "ck") if chaos else None
    losses = d / ("losses_killed.jsonl" if chaos else "losses_ref.jsonl")
    resumed_from = latest_step(ckpt_dir) if ckpt_dir else None
    state = {"first": True}

    def on_step(step: int, metrics: Dict[str, float]) -> None:
        if state["first"]:
            state["first"] = False
            if resumed_from is not None:
                with open(d / "recovery.jsonl", "a") as f:
                    f.write(json.dumps({
                        "resumed_from": int(resumed_from), "first_step": step,
                        "to_first_step_s": time.perf_counter() - t_start}) + "\n")
                    f.flush()
        with open(losses, "a") as f:
            # json round-trips the float64 exactly: repr is shortest-exact
            f.write(json.dumps({"step": step, "loss": metrics["loss"]}) + "\n")
            f.flush()  # SIGKILL only loses process buffers, not OS buffers

    run_training(train_config(device), n_steps=p["n_steps"], global_batch=p["global_batch"],
                 seq_len=p["seq_len"], ckpt_dir=ckpt_dir, ckpt_every=p["ckpt_every"],
                 on_step=on_step, chaos=chaos, seed=seed, device=device)
    return 0


def _child_campaign(seed: int, campaign_id: str, journal_root: str) -> int:
    from ..core import smartcomponents as _smart  # noqa: F401 — registers the demo components
    from ..core.campaign import Campaign, CampaignCell
    from ..core.configstore import ConfigStore
    from ..launch.campaign import build_measure
    from ..runtime.chaos import ChaosInjector, Fault

    # Uneven budgets so the short cell COMPLETES while the long one is still
    # measuring — the kill targets exactly that window.
    cells = [
        CampaignCell("torch_hashtable", "n1024l2", "collisions", mode="min",
                     optimizer="bo", budget=2, seed=seed),
        CampaignCell("torch_spinlock", "heavy2", "throughput_ops_s", mode="max",
                     optimizer="bo", budget=10, seed=seed),
    ]
    chaos = ChaosInjector([Fault(0, "kill")],
                          journal=str(Path(journal_root) / f"{campaign_id}.chaos.jsonl"))
    inner = build_measure(reps=1, device="cpu")   # the demo components run on the host
    campaign = Campaign(cells, lambda c, s: inner(c, s), campaign_id=campaign_id,
                        store=ConfigStore(str(Path(journal_root) / "store")),
                        journal_root=journal_root)

    def measure(cell: CampaignCell, settings: Dict[str, Any]) -> Dict[str, float]:
        # fire the (once-only) kill as soon as some cell has fully completed
        path = Path(campaign.journal.path)
        if path.exists() and '"cell_done"' in path.read_text():
            chaos.on_step(0)
        return inner(cell, settings)

    campaign.measure = measure
    campaign.run()
    return 0


# -- parent-side pieces -------------------------------------------------------
def _spawn(mode: str, d: Path, seed: int, quick: bool, device: str, *extra: str) -> List[str]:
    argv = [sys.executable, "-m", "repro_torch.bench.fault_tolerance", "--child", mode,
            "--dir", str(d), "--seed", str(seed), "--device", device]
    if quick:
        argv.append("--quick")
    return argv + list(extra)


def _env() -> Dict[str, str]:
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, **CHILD_ENV,
            "PYTHONPATH": str(SRC) + (os.pathsep + path if path else "")}


def _read_jsonl(path: Path) -> List[Dict[str, Any]]:
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def _kill_resume_exact(d: Path, seed: int, quick: bool, device: str) -> Dict[str, Any]:
    from ..runtime.chaos import kills, plan_to_json, respawn

    p = _train_params(quick)
    n_kills = _n_kills(quick)
    plan = kills(seed, n_steps=p["n_steps"] - KILL_EXTRA_STEPS, n_kills=n_kills)
    restarts = respawn(_spawn("train", d, seed, quick, device), max_restarts=n_kills + 2,
                       env=_env())
    respawn(_spawn("train", d, seed, quick, device, "--no-chaos"), max_restarts=0, env=_env())

    ref = {r["step"]: r["loss"] for r in _read_jsonl(d / "losses_ref.jsonl")}
    killed_rows = _read_jsonl(d / "losses_killed.jsonl")
    killed: Dict[int, float] = {}
    overlap_identical = True
    for r in killed_rows:
        s, v = r["step"], r["loss"]
        if s in killed and killed[s] != v:   # re-executed step diverged
            overlap_identical = False
        killed[s] = v
    bit_identical = (overlap_identical
                     and sorted(killed) == sorted(ref)
                     and all(killed[s] == ref[s] for s in ref))
    recovery = _read_jsonl(d / "recovery.jsonl")
    return {
        "n_steps": p["n_steps"], "kills": len(plan),
        "kill_steps": [f.at_step for f in plan], "restarts": restarts,
        "reexecuted_steps": len(killed_rows) - len(killed),
        "overlap_identical": overlap_identical, "bit_identical": bit_identical,
        "losses": [killed[s] for s in sorted(killed)],
        "recovery_s": [r["to_first_step_s"] for r in recovery],
        "plan": json.loads(plan_to_json(plan)),
    }


def _campaign_no_replay(d: Path, seed: int, device: str, out_dir: Path) -> Dict[str, Any]:
    campaign_id = f"fault-tolerance-{seed}"
    root = out_dir / "campaign"
    for stale in (root / f"{campaign_id}.jsonl", root / f"{campaign_id}.chaos.jsonl"):
        if stale.exists():
            stale.unlink()  # a fresh campaign, not a resume of the last bench run
    argv = _spawn("campaign", d, seed, False, device, "--id", campaign_id,
                  "--journal-root", str(root))
    journal = root / f"{campaign_id}.jsonl"
    first = subprocess.run(argv, env=_env())
    if first.returncode == 0:
        raise RuntimeError("campaign child was expected to be killed")
    rows_before = _read_jsonl(journal)
    done_before = {r["cell_id"] for r in rows_before if r["kind"] == "cell_done"}
    evals_before = sum(1 for r in rows_before if r["kind"] == "eval")
    if not done_before:
        raise RuntimeError("kill fired before any cell completed — bad schedule")
    second = subprocess.run(argv, env=_env())
    if second.returncode != 0:
        raise RuntimeError("resumed campaign did not complete")
    rows_after = _read_jsonl(journal)[len(rows_before):]
    replayed = sum(1 for r in rows_after
                   if r["kind"] == "eval" and r["cell_id"] in done_before)
    resumed = max((int(r.get("resumed", 0)) for r in rows_after
                   if r["kind"] == "campaign_start"), default=0)
    return {
        "campaign_id": campaign_id,
        "completed_before_kill": len(done_before),
        "evals_before_kill": evals_before,
        "evals_after_kill": sum(1 for r in rows_after if r["kind"] == "eval"),
        "replayed_completed_evals": replayed,
        "cells_resumed_exactly": resumed,
    }


def _torn_fallback(d: Path, seed: int, device: str) -> Dict[str, Any]:
    import torch

    from ..runtime.chaos import corrupt_checkpoint
    from ..runtime.checkpoint import latest_step, restore_checkpoint
    from ..runtime.steps import init_train_state

    ck = str(d / "ck")  # the killed run's surviving checkpoints
    newest = latest_step(ck)
    corrupt_checkpoint(ck)
    gen = torch.Generator(device=device).manual_seed(seed)
    template = init_train_state(train_config(device), gen, device)
    _, manifest = restore_checkpoint(ck, template)
    return {"newest": int(newest), "restored": int(manifest["step"]),
            "fell_back": int(manifest["step"]) < int(newest)}


def _ckpt_overhead(seed: int, quick: bool, device: str) -> Dict[str, Any]:
    from ..runtime.train_loop import run_training

    reps = 6 if quick else 10
    # 3 steps of compute between saves is what the async writer overlaps
    # with; back-to-back saves would re-serialize on the wait() handoff
    samples: Dict[str, List[float]] = {"async": [], "blocking": []}
    for rep in range(reps):
        for mode in ("async", "blocking"):
            with tempfile.TemporaryDirectory() as td:
                out = run_training(train_config(device), n_steps=9, global_batch=2, seq_len=32,
                                   ckpt_dir=td, ckpt_every=3, ckpt_overrides={"mode": mode},
                                   seed=seed + rep, device=device)
            samples[mode].append(1000.0 * float(out["ckpt_counters"]["blocked_s"]))
    verdict = stats.compare(samples["blocking"], samples["async"], mode="min", seed=seed)
    return {"async_blocked_ms": samples["async"],
            "blocking_blocked_ms": samples["blocking"],
            "saves_per_run": 3, "verdict": verdict.to_dict()}


def run(quick: bool = False, seed: int = 7, *, device: Any = "cuda",
        out_dir: Any = BENCH_ROOT) -> Dict[str, Any]:
    """Every claim, measured; writes ``fault_tolerance.json`` under ``out_dir``."""
    import torch

    dev = str(require_device(device))
    out = Path(out_dir)
    t0 = time.time()
    res: Dict[str, Any] = {"quick": quick, "seed": seed, "device": dev,
                           "device_name": (torch.cuda.get_device_name(0)
                                           if dev.startswith("cuda") else "cpu")}
    with tempfile.TemporaryDirectory() as td:
        d = Path(td)
        res["train"] = _kill_resume_exact(d, seed, quick, dev)
        res["torn"] = _torn_fallback(d, seed, dev)
        res["campaign"] = _campaign_no_replay(d, seed, dev, out)
    res["ckpt_overhead"] = _ckpt_overhead(seed, quick, dev)
    res["wall_s"] = time.time() - t0

    tr = res["train"]
    print(f"  kill→resume ({dev}): {tr['kills']} kills at steps {tr['kill_steps']}, "
          f"{tr['restarts']} restarts, re-executed {tr['reexecuted_steps']} "
          f"step(s), bit_identical={tr['bit_identical']}")
    print(f"  recovery_s: {[round(s, 2) for s in tr['recovery_s']]}")
    print(f"  torn ckpt: newest {res['torn']['newest']} → restored "
          f"{res['torn']['restored']} (fell_back={res['torn']['fell_back']})")
    ca = res["campaign"]
    print(f"  campaign: {ca['completed_before_kill']} cell(s) done pre-kill, "
          f"replayed evals for them: {ca['replayed_completed_evals']}")
    co = res["ckpt_overhead"]
    v = co["verdict"]
    print(f"  async-vs-blocking blocked time: {v['verdict']} "
          f"(effect {v['effect']:+.1%}, p={v['p_value']}); ms async "
          f"{[round(x, 2) for x in co['async_blocked_ms']]}, blocking "
          f"{[round(x, 2) for x in co['blocking_blocked_ms']]}")
    out.mkdir(parents=True, exist_ok=True)
    (out / "fault_tolerance.json").write_text(json.dumps(res, indent=1))
    return res


def bench(quick: bool = False, seed: int = 7, *, device: Any = "cuda",
          out_dir: Any = BENCH_ROOT) -> list:
    """Runner protocol: recovery-time and checkpoint-blocked-time sample
    distributions under the ``torch_train_checkpoint`` context of the
    model's state, with the exactness facts riding the records' meta."""
    from ..core.baseline import BenchRecord

    res = run(quick=quick, seed=seed, device=device, out_dir=out_dir)
    wl = GRIDS["training"]["torch_train_checkpoint"][0]
    tr, ca = res["train"], res["campaign"]
    return [
        BenchRecord.for_component(
            "fault_tolerance", "recovery_s", tr["recovery_s"],
            "torch_train_checkpoint", wl, mode="min", unit="s",
            kills=tr["kills"], bit_identical=tr["bit_identical"],
            replayed_completed_evals=ca["replayed_completed_evals"]),
        BenchRecord.for_component(
            "fault_tolerance", "ckpt_blocked_ms",
            res["ckpt_overhead"]["async_blocked_ms"],
            "torch_train_checkpoint", wl, mode="min", unit="ms",
            vs_blocking=res["ckpt_overhead"]["verdict"]),
    ]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=str(BENCH_ROOT))
    ap.add_argument("--child", choices=("train", "campaign"), default=None)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--id", default=None)
    ap.add_argument("--journal-root", default=None)
    ap.add_argument("--no-chaos", action="store_true",
                    help="(child train) uninterrupted reference run")
    args = ap.parse_args(argv)

    if args.child == "train":
        from ..runtime.chaos import kills, plan_to_json

        p = _train_params(args.quick)
        plan_json = ("" if args.no_chaos else plan_to_json(
            kills(args.seed, n_steps=p["n_steps"] - KILL_EXTRA_STEPS,
                  n_kills=_n_kills(args.quick))))
        return _child_train(Path(args.dir), args.seed, args.quick, plan_json, args.device)
    if args.child == "campaign":
        return _child_campaign(args.seed, args.id, args.journal_root)

    res = run(quick=args.quick, seed=args.seed, device=args.device, out_dir=args.out_dir)
    ok = (res["train"]["bit_identical"]
          and res["campaign"]["replayed_completed_evals"] == 0
          and res["ckpt_overhead"]["verdict"]["verdict"] == "improved")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
