"""Launch tuning campaigns over declarative component × workload grids.

The port of ``repro/launch/campaign.py``: named grids expand to
:class:`CampaignCell` lists, each component gets a real measurement
function (:mod:`repro_torch.launch.microbench` for the kernels, a reduced
OLMo-1B :class:`~repro_torch.runtime.serve_loop.BatchedServer` run for
serving, a short reduced OLMo-1B ``run_training`` and the input pipeline
for ``training``, the deterministic demo components for ``demo``), and the
grid runs through one
mux with warm-start transfer, a resumable journal and gated promotion into
the config store:

    PYTHONPATH=src python -m repro_torch.launch.campaign --grid kernels      # on the card
    PYTHONPATH=src python -m repro_torch.launch.campaign --grid serving      # on the card
    PYTHONPATH=src python -m repro_torch.launch.campaign --grid training     # on the card
    PYTHONPATH=src python -m repro_torch.launch.campaign --grid demo --budget 8
    PYTHONPATH=src python -m repro_torch.launch.campaign --id <id> ...       # resume

The ``kernels`` and ``serving`` grids run on the card unless ``--device
cpu`` is given, and need one: they do not fall back to the CPU.  On a CUDA
device each kernel cell pins ``impl`` to ``kernel`` (the pin is part of the
cell, written in the journal's ``cell_start`` row) and searches the
kernel's launch tunables; the reference instead rewrites a ``pallas`` impl into a plain one
off the TPU.  On the CPU the cells search the whole space, and ``kernel``
routes to the plain version there.  A timed cell's promotion is gated on
interleaved measurements of the default and the best config
(:mod:`repro_torch.core.campaign`), so the comparator can reach a p-value.
The ``training`` grid's workloads are the signatures the port's
``run_training`` resolves: ``kb2048`` is the reduced OLMo-1B's train state
(float32 on the CPU, bf16 on the card: both round up to 2048 KiB), and the
pipeline's ``b4s128``/``b8s256`` are the (batch, seq) buckets it measures.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import smartcomponents as _smart  # noqa: F401 — registers the demo components
from ..core.campaign import CAMPAIGN_ROOT, Campaign, CampaignCell, CellResult
from ..core.configstore import ConfigStore, _sig_fields, default_store
from ..data import pipeline as _pipeline  # noqa: F401 — registers torch_data_pipeline
from ..kernels.flash_attention import ops as attn_ops
from ..kernels.rmsnorm import ops as rms_ops
from ..kernels.ssd import ops as ssd_ops
from ..runtime import checkpoint as _checkpoint  # noqa: F401 — registers torch_train_checkpoint
from .microbench import candidate, time_samples_us
from .tuning import apply_overrides, parse_override

__all__ = ["GRIDS", "CARD_PINS", "grid_cells", "build_measure", "run_grid", "main"]

# The widths of the models the port serves: OLMo-1B attention (16 heads of
# 128, no GQA), mamba2-780m's norm (d 1536) and SSD (48 heads of 64, state
# 128, one group).
ATTN_HEADS, ATTN_KV_HEADS = 16, 16
SSD_HEAD_DIM, SSD_STATE, SSD_GROUPS = 64, 128, 1

# Representative workloads per grid, in the components' own signature
# format, so a campaign-tuned entry is exactly what the op resolves.
GRIDS: Dict[str, Dict[str, List[str]]] = {
    "kernels": {
        "torch_flash_attention": [
            attn_ops.workload_signature(1, 128, 128, 128),
            attn_ops.workload_signature(2, 256, 256, 128),
            attn_ops.workload_signature(2, 512, 512, 128),
            attn_ops.workload_signature(4, 1024, 1024, 128),
        ],
        "torch_rmsnorm_kernel": [
            rms_ops.workload_signature(2048, 1536),
            rms_ops.workload_signature(16384, 1536),
        ],
        "torch_ssd_kernel": [
            ssd_ops.workload_signature(1, 256, 48),
            ssd_ops.workload_signature(2, 512, 48),
        ],
    },
    "serving": {
        "torch_serve_batching": ["reduced_c128", "reduced_c512"],
    },
    "training": {
        "torch_train_checkpoint": ["kb2048"],
        "torch_data_pipeline": ["b4s128", "b8s256"],
    },
    "demo": {
        "torch_hashtable": ["n1024l2", "n2048l2", "n4096l4"],
        "torch_spinlock": ["heavy2", "heavy8"],
    },
}

# What a cell on a CUDA device does not search: the kernel itself.
CARD_PINS: Dict[str, Tuple[Tuple[str, Any], ...]] = {
    "torch_flash_attention": (("impl", "kernel"),),
    "torch_rmsnorm_kernel": (("impl", "kernel"),),
    "torch_ssd_kernel": (("impl", "kernel"),),
}

_OBJECTIVES = {
    "torch_flash_attention": ("time_us", "min"),
    "torch_rmsnorm_kernel": ("time_us", "min"),
    "torch_ssd_kernel": ("time_us", "min"),
    "torch_serve_batching": ("tokens_per_s", "max"),
    "torch_train_checkpoint": ("overhead_ms", "min"),
    "torch_data_pipeline": ("batch_ms", "min"),
    "torch_hashtable": ("collisions", "min"),
    "torch_spinlock": ("throughput_ops_s", "max"),
}


def grid_cells(grid: str, *, budget: int, optimizer: str, seed: int,
               quick: bool = False, device: Any = "cuda") -> List[CampaignCell]:
    """The grid's cells; on a CUDA device the kernel cells carry
    :data:`CARD_PINS`.  Seeds as the reference's: ``seed + i`` for a
    component's i-th workload."""
    if grid not in GRIDS:
        raise ValueError(f"unknown grid {grid!r} (have {sorted(GRIDS)})")
    on_card = torch.device(device).type == "cuda"
    cells = []
    for comp, workloads in GRIDS[grid].items():
        if quick:
            workloads = workloads[:2]
        objective, mode = _OBJECTIVES[comp]
        pin = CARD_PINS.get(comp, ()) if on_card else ()
        for i, wl in enumerate(workloads):
            cells.append(CampaignCell(
                comp, wl, objective, mode=mode, optimizer=optimizer,
                budget=budget, seed=seed + i, pin=pin))
    return cells


# -- measurement functions ----------------------------------------------------
def _randn(gen: torch.Generator, shape, device, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@functools.lru_cache(maxsize=16)
def _attn_data(b: int, s: int, d: int, device: str):
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn(gen, (b, s, ATTN_HEADS, d), device, torch.bfloat16)
    k = _randn(gen, (b, s, ATTN_KV_HEADS, d), device, torch.bfloat16)
    v = _randn(gen, (b, s, ATTN_KV_HEADS, d), device, torch.bfloat16)
    return q, k, v


@functools.lru_cache(maxsize=16)
def _rms_data(rows: int, d: int, device: str):
    gen = torch.Generator(device=device).manual_seed(1)
    return _randn(gen, (rows, d), device, torch.bfloat16), torch.ones(d, device=device)


@functools.lru_cache(maxsize=16)
def _ssd_data(b: int, s: int, h: int, device: str):
    gen = torch.Generator(device=device).manual_seed(2)
    p, n, g = SSD_HEAD_DIM, SSD_STATE, SSD_GROUPS
    x = _randn(gen, (b, s, h, p), device, torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=device))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=device))
    B = (torch.randn((b, s, g, n), generator=gen, device=device) / n ** 0.25).to(torch.bfloat16)
    C = (torch.randn((b, s, g, n), generator=gen, device=device) / n ** 0.25).to(torch.bfloat16)
    return x, dt, A, B, C


def _time_us(cell: CampaignCell, fn, args, settings, reps: int) -> Dict[str, float]:
    fn = candidate(cell.component, fn, settings, cell.workload)
    return {"time_us": float(np.median(time_samples_us(fn, *args, reps=reps)))}


def _measure_flash(cell: CampaignCell, settings: Dict[str, Any], reps: int,
                   device: str) -> Dict[str, float]:
    f = _sig_fields(cell.workload)
    args = _attn_data(f["b"], f["q"], f["d"], device)
    fn = lambda q, k, v: attn_ops.flash_attention(
        q, k, v, causal=True, impl=settings["impl"], block_q=settings["block_q"],
        block_kv=settings["block_kv"])
    return _time_us(cell, fn, args, settings, reps)


def _measure_rmsnorm(cell: CampaignCell, settings: Dict[str, Any], reps: int,
                     device: str) -> Dict[str, float]:
    f = _sig_fields(cell.workload)
    args = _rms_data(f["r"], f["d"], device)
    fn = lambda x, scale: rms_ops.rmsnorm(
        x, scale, impl=settings["impl"], block_rows=settings["block_rows"],
        row_threads=settings["row_threads"])
    return _time_us(cell, fn, args, settings, reps)


def _measure_ssd(cell: CampaignCell, settings: Dict[str, Any], reps: int,
                 device: str) -> Dict[str, float]:
    f = _sig_fields(cell.workload)
    args = _ssd_data(f["b"], f["s"], f["h"], device)
    fn = lambda *a: ssd_ops.ssd(*a, impl=settings["impl"], chunk=settings["chunk"])
    return _time_us(cell, fn, args, settings, reps)


@functools.lru_cache(maxsize=2)
def _serve_model(device: str):
    """Reduced OLMo-1B, random weights from seed 0: bf16 on the card (the
    served dtype, so prefills run the tensor-core attention kernel), the
    config's float32 on the CPU (the reference's)."""
    from ..configs import get_config
    from ..models import model as M

    cfg = get_config("olmo-1b").reduced().validate()
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else None
    gen = torch.Generator(device=device).manual_seed(0)
    return M.init_params(cfg, gen, device=device, dtype=dtype), cfg


def _measure_serve(cell: CampaignCell, settings: Dict[str, Any], reps: int,
                   device: str) -> Dict[str, float]:
    """One server run of 12 seeded requests under the proposal.  The
    proposal goes through the store's override tier for exactly this
    workload, the path the server resolves at construction, so every tuned
    knob (max_batch included) is live in the measurement."""
    from ..runtime.serve_loop import BatchedServer

    del reps  # one serve run is already an aggregate over many steps
    f = _sig_fields(cell.workload)
    capacity = next(iter(f.values()), 128)
    params, cfg = _serve_model(device)
    store = default_store()
    store.set_override(cell.component, cell.workload, dict(settings))
    try:
        server = BatchedServer(params, cfg, capacity=capacity, workload=cell.workload,
                               device=device)
        rng = np.random.default_rng(cell.seed)
        for _ in range(12):
            plen = int(rng.integers(4, 12))
            server.submit(rng.integers(2, 250, size=plen).astype(np.int32))
        m = server.run()  # max_new_tokens resolves from the override
    finally:
        store.clear_override(cell.component, cell.workload)
    # every metric the component declares: telemetry packing needs the set
    return {k: float(m[k]) for k in
            ("tokens_per_s", "p50_latency_s", "queue_depth", "live_slots")}


def train_config(device: str):
    """Reduced OLMo-1B for the training cells: the config's float32 on the
    CPU (the reference's), bf16 on the card (the dtype training runs in)."""
    from ..configs import get_config

    cfg = get_config("olmo-1b").reduced().validate()
    return dataclasses.replace(cfg, dtype="bfloat16") if device.startswith("cuda") else cfg


def _measure_train_checkpoint(cell: CampaignCell, settings: Dict[str, Any], reps: int,
                              device: str) -> Dict[str, float]:
    """A short real training run under the proposed checkpoint policy.

    ``blocked_ms``: wall time the train loop spent inside save().
    ``recovery_ms``: measured restore latency from the run's own checkpoints
    plus re-training half an interval.  ``overhead_ms``: the tuned
    objective — blocked time plus the *expected* recovery bill, P_fault ×
    steps × recovery: a huge interval minimizes blocked time but loses half
    an interval of work per fault; a tiny one pays save cost every step."""
    from ..runtime.checkpoint import restore_checkpoint
    from ..runtime.steps import init_train_state
    from ..runtime.train_loop import run_training

    del reps
    p_fault = 0.05  # faults per step, pessimistic cluster assumption
    n_steps = 8
    cfg = train_config(device)
    with tempfile.TemporaryDirectory() as td:
        out = run_training(cfg, n_steps=n_steps, global_batch=2, seq_len=32,
                           ckpt_dir=td, ckpt_overrides=dict(settings),
                           seed=cell.seed, device=device)
        blocked_ms = 1000.0 * float(out["ckpt_counters"]["blocked_s"])
        gen = torch.Generator(device=device).manual_seed(cell.seed)
        template = init_train_state(cfg, gen, device)
        t0 = time.perf_counter()
        restore_checkpoint(td, template)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        restore_ms = 1000.0 * (time.perf_counter() - t0)
    step_ms = 1000.0 * float(np.median([h["step_time_s"] for h in out["history"]] or [0.0]))
    every = int(settings["ckpt_every"])
    recovery_ms = restore_ms + 0.5 * min(every, n_steps) * step_ms
    overhead_ms = blocked_ms + p_fault * n_steps * recovery_ms
    return {"blocked_ms": blocked_ms, "recovery_ms": recovery_ms, "overhead_ms": overhead_ms}


def _measure_data_pipeline(cell: CampaignCell, settings: Dict[str, Any], reps: int,
                           device: str) -> Dict[str, float]:
    """Consumer-side batch latency under the proposed prefetch settings.

    The proposal goes through the store's override tier for exactly this
    workload, the signature ``PrefetchingBatcher`` computes from (batch,
    seq), so the measurement exercises the resolution path.  A 2 ms gap
    between fetches (the "train step") gives look-ahead something to
    overlap with.  The pipeline is numpy on the host: ``device`` is not
    used."""
    from ..data.pipeline import PackedBatcher, PrefetchingBatcher, SyntheticCorpus

    del reps, device
    f = _sig_fields(cell.workload)
    gb, seq = int(f["b"]), int(f["s"])
    store = default_store()
    store.set_override(cell.component, cell.workload, dict(settings))
    try:
        pf = PrefetchingBatcher(PackedBatcher(SyntheticCorpus(512, seed=cell.seed), gb, seq))
        if pf.prefetch_depth != int(settings["prefetch_depth"]):
            raise RuntimeError(f"the override did not resolve: depth {pf.prefetch_depth}")
        lat = []
        for step in range(16):
            t0 = time.perf_counter()
            pf.batch_at(step)
            lat.append(1000.0 * (time.perf_counter() - t0))
            time.sleep(0.002)
        stall_ms = 1000.0 * float(pf.counters["stall_s"])
        pf.close()
    finally:
        store.clear_override(cell.component, cell.workload)
    return {"batch_ms": float(np.median(lat)), "stall_ms": stall_ms}


def _measure_hashtable(cell: CampaignCell, settings: Dict[str, Any], reps: int,
                       device: str) -> Dict[str, float]:
    from ..core.smartcomponents import TunableHashTable, hashtable_workload

    del reps, device  # deterministic: collisions depend only on (settings, workload)
    f = _sig_fields(cell.workload)
    table = TunableHashTable(**settings)
    return hashtable_workload(table, n_keys=f.get("n", 2000),
                              lookup_ratio=float(f.get("l", 2)), seed=cell.seed)


def _measure_spinlock(cell: CampaignCell, settings: Dict[str, Any], reps: int,
                      device: str) -> Dict[str, float]:
    from ..core.smartcomponents import SpinLock, spinlock_workload

    del reps, device  # deterministic discrete-event model
    f = _sig_fields(cell.workload)
    lock = SpinLock(**settings)
    return spinlock_workload(lock, heavy_ops=f.get("heavy", 4), seed=cell.seed)


_MEASURES = {
    "torch_flash_attention": _measure_flash,
    "torch_rmsnorm_kernel": _measure_rmsnorm,
    "torch_ssd_kernel": _measure_ssd,
    "torch_serve_batching": _measure_serve,
    "torch_train_checkpoint": _measure_train_checkpoint,
    "torch_data_pipeline": _measure_data_pipeline,
    "torch_hashtable": _measure_hashtable,
    "torch_spinlock": _measure_spinlock,
}


def build_measure(reps: int = 3, device: Any = "cuda"):
    """Component-dispatching ``measure(cell, settings)`` for the Campaign."""
    dev = str(torch.device(device))

    def measure(cell: CampaignCell, settings: Dict[str, Any]) -> Dict[str, float]:
        return _MEASURES[cell.component](cell, settings, reps, dev)
    return measure


def run_grid(grid: str, *, budget: int = 12, optimizer: str = "bo", seed: int = 0,
             quick: bool = False, device: Any = "cuda", campaign_id: Optional[str] = None,
             store: Optional[ConfigStore] = None, journal_root: Any = CAMPAIGN_ROOT,
             reps: int = 3, warm_start: bool = True) -> Tuple[Campaign, Dict[str, CellResult]]:
    """Build the grid's cells and measure, run the campaign, return both.
    A kernels, serving or training grid on a CUDA device that finds none
    raises."""
    if grid != "demo" and torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the {grid} grid runs on the card and no CUDA device is visible; "
                           "pass device='cpu' to run it on the CPU")
    cells = grid_cells(grid, budget=budget, optimizer=optimizer, seed=seed, quick=quick,
                       device=device)
    campaign = Campaign(cells, build_measure(reps=reps, device=device),
                        campaign_id=campaign_id, store=store or default_store(),
                        journal_root=journal_root, warm_start=warm_start)
    return campaign, campaign.run()


def describe(r: CellResult) -> str:
    """One line per cell: default and best objective, best settings,
    evaluations, warm start, promotion and the gate's verdict."""
    base = f"default={np.median(r.baseline):12.2f}" if r.baseline else f"{'':20s}"
    warm = (f"warm<-{r.warm_start['source_workload']}(d={r.warm_start['distance']:.0f})"
            if r.warm_start else "cold")
    flag = "resumed" if r.resumed else ("promoted" if r.promoted else "rejected")
    gate = r.gate or {}
    verdict = gate.get("verdict", "-")
    p = gate.get("p_value")
    return (f"{r.cell.cell_id:42s} {base} best={r.best_value:12.2f} {r.best_config} "
            f"evals={r.evaluations} {warm} {flag} gate={verdict}"
            + (f"(p={p:.4f}, effect={gate['effect']:+.3f})" if p is not None else ""))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--grid", default="demo", choices=sorted(GRIDS))
    ap.add_argument("--budget", type=int, default=12)
    ap.add_argument("--optimizer", default="bo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--id", default=None, help="campaign id (reuse to resume)")
    ap.add_argument("--quick", action="store_true",
                    help="2 workloads per component, half the budget (at least 4)")
    ap.add_argument("--no-warm", action="store_true",
                    help="disable cross-context warm starts (A/B baseline)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing samples per evaluation (kernel grids)")
    ap.add_argument("--device", default="cuda",
                    help="device of the kernels and serving grids (cuda or cpu)")
    ap.add_argument("--store", default=None, help="config store root (default: results/configstore)")
    ap.add_argument("--journal-root", default=str(CAMPAIGN_ROOT), help="campaign journal directory")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="launch override, e.g. torch_ssd_kernel@b1s256h48.chunk=32")
    ap.add_argument("--list", action="store_true", help="print the grid and exit")
    args = ap.parse_args(argv)

    for s in args.set:
        apply_overrides(parse_override(s))
    budget = max(4, args.budget // 2) if args.quick else args.budget
    if args.list:
        for c in grid_cells(args.grid, budget=budget, optimizer=args.optimizer,
                            seed=args.seed, quick=args.quick, device=args.device):
            print(f"{c.cell_id}  budget={c.budget} optimizer={c.optimizer} "
                  f"objective={c.objective}({c.mode}) pin={dict(c.pin)}")
        return 0
    store = ConfigStore(args.store) if args.store else None
    campaign, results = run_grid(
        args.grid, budget=budget, optimizer=args.optimizer, seed=args.seed, quick=args.quick,
        device=args.device, campaign_id=args.id, store=store, journal_root=args.journal_root,
        reps=2 if args.quick else args.reps, warm_start=not args.no_warm)
    print(f"campaign {campaign.campaign_id}: {len(results)} cells ({args.grid} grid), "
          f"journal {campaign.journal.path}, store {campaign.store.root}")
    for _, r in sorted(results.items()):
        print("  " + describe(r))
    promoted = sum(r.promoted for r in results.values())
    print(f"{promoted}/{len(results)} cells promoted into the config store")
    return 0


if __name__ == "__main__":
    sys.exit(main())
