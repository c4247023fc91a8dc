# mloslint: disable-file=MLOS002 -- this module IS the launch-layer tier machinery: it
# snapshots, pins, and restores raw global-tier .settings around dry-run cells so that
# everything else can stay on settings_for; reads here are save/restore, not resolution.
"""The dry-run: does a cell fit the card, what bounds its step, and how far from it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh one          # sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k --mesh one --set torch_layer_stack.remat=dots

The port of ``repro/launch/dryrun.py``.  A cell (arch × shape × mesh) is
traced on ``meta`` tensors (:mod:`.specs`): shapes and dtypes, no byte
allocated, nothing launched on a card, so every full-size cell is planned
on the host.  On ``one`` (the card of :data:`.mesh.HW`):

  * a production trace of the step at full depth gives ``per_device_bytes``,
    the peak of live storage (state plus temporaries, as the port allocates
    them: the plain ``decode_attention``'s float32 cache copies included)
    and ``fits``; where the card would launch a kernel, the trace allocates
    what the kernel allocates (its outputs, the SSD kernel's scratch);
  * counter traces at k = 1 and 2 depth units, extrapolated linearly to the
    model's depth (exact: the units are identical), give FLOPs, bytes and
    collective bytes (:func:`repro_torch.core.telemetry.op_counters`); where
    the card would launch a kernel they run its plain FLOP-equivalent (the
    reference's ``_COUNTER_IMPL_MAP``), whose forward attention bytes
    :func:`.adjust.attention_adjustment` then replaces by the kernel's;
  * the roofline over the card's peaks: ``compute_s``, ``memory_s``,
    ``collective_s``, ``bottleneck``, ``step_time_bound_s``,
    ``useful_flops_ratio`` and ``roofline_fraction``.

On the reference's production meshes (``single``, ``multi``) the cell is
the sharded program, traced the same way as rank 0's local program: inside
:func:`.mesh.traced_group` (a ``fake`` process group of the mesh's size at
rank 0, destroyed when the cell ends) its arguments are meta DTensors
placed by the cell's rules, the step runs on DTensors, and every counter is
rank 0's: its shards' peak, its local ops' FLOPs and bytes, its
collectives' bytes by kind and by mesh axis (``counters["collectives"]``).
``per_device_bytes`` and ``fits`` are one H100's; ``memory["state"]``
breaks down the parameters, optimizer state, caches and batch a device
holds.  ``collective_s`` divides by one card's link: NVLink within an
8-card node, the network on ``single`` and ``multi``
(:func:`.mesh.link_bw`).  The reference's ``f32_shadow_bytes`` and
``tpu_memory_estimate_bytes`` correct an XLA-CPU artefact and are not
carried over.  Results go to ``results/torch/dryrun/`` (resumable).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..configs import ALL_ARCHS, get_config
from ..core import configstore
from ..core.optimizers import optimizer_defaults, set_optimizer_defaults
from ..core.telemetry import op_counters, os_counters
from ..kernels.flash_attention import kernel as attn_kernel
from ..kernels.flash_attention import ops as attn_ops
from ..kernels.ssd import kernel as ssd_kernel
from ..kernels.ssd import ops as ssd_ops
from ..kernels.ssd import ref as ssd_ref
from ..models.layers import dtype_of
from ..parallel import sharding as shd
from .adjust import attention_adjustment, plain_forward
from .mesh import HW, MESHES, get_mesh, link_bw, traced_group
from .roofline import DRYRUN_DIR
from .shapes import SHAPES, Shape, cell_status
from .specs import CellPlan, build_cell, cell_rules, cell_specs, depth_units
from .tuning import SINGLETONS, apply_overrides, current_settings, parse_override, split_target

__all__ = ["run_cell", "trace", "extrapolated_counters", "kernel_stand_ins", "state_bytes",
           "default_microbatches", "cell_path", "OUT_DIR", "COUNTER_KEYS"]

OUT_DIR = Path(DRYRUN_DIR)
COUNTER_KEYS = ("flops", "bytes_accessed", "collective_bytes", "ops")


@contextlib.contextmanager
def kernel_stand_ins(mode: str):
    """Where the card would launch a kernel, a ``meta`` trace runs a stand-in:
    ``"alloc"`` allocates what the kernel allocates (the production trace's
    memory), ``"plain"`` computes the kernel's plain FLOP-equivalent (the
    counter traces).  The wrappers' argument checks read device pointers,
    which meta tensors do not have, and are skipped; no launch is counted.
    ``FlashAttentionFn`` and ``SsdFn`` stay, so a train step's backward is
    the plain recompute the port runs."""
    if mode not in ("alloc", "plain"):
        raise ValueError(f"stand-in mode {mode!r}: alloc or plain")

    def attention(q, k, v, causal, window, q_offset, block_q, block_kv, scale):
        if mode == "alloc":
            return torch.empty_like(q)
        return plain_forward(q, k, v, causal, window, q_offset, block_q, block_kv, scale)

    def ssd(x, dt, A, B, C, D, chunk, return_state):
        b, s, h, p = x.shape
        n = B.shape[3]
        if mode == "plain":
            with torch.no_grad():
                y, state = ssd_ref.ssd_chunked(x, dt, A, B, C, D,
                                               chunk=ssd_ref.align_chunk(chunk, s),
                                               return_state=True)
            return y, (state if return_state else None)
        y = torch.empty_like(x)
        state = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
                 if return_state else None)
        if ssd_kernel.SOURCES[x.dtype] == "ssd_tc":       # the passes' scratch, one a call
            n_states = b * -(-s // chunk) * h
            torch.empty(6 * n_states * p * n + 4 * n_states, dtype=torch.uint8, device=x.device)
        return y, state

    saved = [(m, name, getattr(m, name)) for m in (attn_kernel, ssd_kernel)
             for name in ("_check", "_launch")]
    attn_kernel._check = lambda *a: None
    attn_kernel._launch = attention
    ssd_kernel._check = lambda *a: None
    ssd_kernel._launch = ssd
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


@contextlib.contextmanager
def _temp_settings(overrides: Dict[str, Dict[str, Any]]):
    """Scoped apply_overrides: every tier (a singleton's settings, the
    optimizer defaults, a context-targeted store override) is restored on
    exit, with each singleton's explicit-set bookkeeping."""
    saved, saved_ctx, saved_opt = {}, {}, None
    store = configstore.default_store()
    for target in overrides:
        comp, workload = split_target(target)
        if workload:
            saved_ctx[(comp, workload)] = store.get_override(comp, workload)
        elif comp == "optimizer":
            saved_opt = optimizer_defaults()
        else:
            inst = SINGLETONS[comp]
            saved[comp] = (dict(inst.settings), set(getattr(inst, "_explicit_settings", ())))
    try:
        apply_overrides(overrides)
        yield
    finally:
        for k, (settings, explicit) in saved.items():
            SINGLETONS[k].settings = settings  # pre-validated snapshot
            SINGLETONS[k]._explicit_settings = explicit
        if saved_opt is not None:
            set_optimizer_defaults(**saved_opt)
        for (comp, workload), prev in saved_ctx.items():
            store.clear_override(comp, workload)
            if prev:
                store.set_override(comp, workload, prev)


def _redeploy_stored_cell_configs(workload: str):
    """The redeploy step of tune → validate → persist → REDEPLOY: settings
    persisted for exactly this cell context (``perf.hillclimb`` winners) are
    applied for the cell's duration.  Keys set explicitly in this process
    (``--set``) are left alone.  Afterwards every singleton is PINNED (all
    keys explicit) for the cell, so the recorded settings are what the
    traces ran.  Returns (applied, undo); stale entries are skipped."""
    store = configstore.default_store()
    saved, applied = [], {}
    for comp, inst in SINGLETONS.items():
        explicit = set(getattr(inst, "_explicit_settings", ()))
        saved.append((inst, dict(inst.settings), explicit))
        try:
            entry = store.resolve_entry(configstore.context_for(comp, workload))
        except (OSError, ValueError, KeyError) as e:   # an unreadable store ≠ a dead sweep
            print(f"[configstore] skipping store for {comp}@{workload}: {e}")
            entry = None
        kv = {}
        if entry is not None and entry["context"].get("workload") == workload:
            kv = {k: v for k, v in entry["settings"].items()
                  if k not in explicit and k in inst.settings}
        if kv:
            try:
                inst.apply_settings(kv)
                applied[comp] = kv
            except (ValueError, KeyError, TypeError) as e:   # a stale or hand-edited entry
                inst.settings = dict(saved[-1][1])
                print(f"[configstore] skipping stale entry {comp}@{workload}: {e}")
        inst._explicit_settings = set(inst.settings)  # pin for the cell

    def undo():
        for inst, settings, expl in saved:
            inst.settings = settings
            inst._explicit_settings = expl

    return applied, undo


def default_microbatches(arch: str, shape_name: str) -> int:
    """Grad-accumulation default: big models microbatch to bound live
    activations (an MLOS class-b tunable; the heuristic is the default)."""
    if shape_name != "train_4k":
        return 1
    return 4 if get_config(arch).param_count() > 4e10 else 1


def trace(plan: CellPlan, mode: str) -> Dict[str, float]:
    """:func:`op_counters` of one call of the plan's step, the kernels stood
    in by ``mode`` (:func:`kernel_stand_ins`)."""
    with kernel_stand_ins(mode):
        return op_counters(plan.step, *plan.args, device_mesh=plan.device_mesh)


def _extrapolate_collectives(c1: Dict[str, Any], c2: Dict[str, Any], K: int) -> Dict[str, Any]:
    """Per kind, count, bytes and bytes by axes at K units from 1 and 2."""
    out: Dict[str, Any] = {}
    for kind in sorted(set(c1) | set(c2)):
        a = c1.get(kind, {"count": 0, "bytes": 0.0, "axes": {}})
        b = c2.get(kind, {"count": 0, "bytes": 0.0, "axes": {}})
        lin = lambda x, y: x + (K - 1) * (y - x)
        out[kind] = {"count": lin(a["count"], b["count"]), "bytes": lin(a["bytes"], b["bytes"]),
                     "axes": {ax: lin(a["axes"].get(ax, 0.0), b["axes"].get(ax, 0.0))
                              for ax in sorted(set(a["axes"]) | set(b["axes"]))}}
    return out


def extrapolated_counters(arch: str, shape_name: str, microbatches: int, *,
                          cfg=None, shape=None, mesh: Any = "one",
                          device_mesh=None) -> tuple:
    """(counters at the model's depth, the k = 1 and k = 2 passes, units K):
    ``c(K) = c(1) + (K − 1)·(c(2) − c(1))``, exact for identical units; on a
    sharded mesh (``device_mesh`` from :func:`.mesh.traced_group`) rank 0's,
    and ``collectives`` extrapolated the same way."""
    cfg = cfg or get_config(arch)
    K = depth_units(cfg)
    cs = [trace(build_cell(arch, shape_name, mesh, microbatches=microbatches, depth_k=k,
                           cfg=cfg, shape=shape, device_mesh=device_mesh), "plain")
          for k in (1, 2)]
    c = {key: cs[0][key] + (K - 1) * (cs[1][key] - cs[0][key]) for key in COUNTER_KEYS}
    if device_mesh is not None:
        c["collectives"] = _extrapolate_collectives(cs[0]["collectives"], cs[1]["collectives"],
                                                    K)
    return c, cs, K


def state_bytes(cfg, shape, mesh) -> Dict[str, float]:
    """One device's state under the mesh's sharding rules: parameters and
    optimizer state with the step counter (train), caches (decode) and the
    batch."""
    rules = cell_rules(shape, mesh)
    dt = dtype_of(cfg)
    specs = cell_specs(cfg, shape)
    parts: Dict[str, float] = {}
    if shape.kind == "train":
        parts["params"] = shd.tree_local_bytes(specs["state"]["params"], rules, mesh, dt)
        parts["opt"] = shd.tree_local_bytes([specs["state"]["opt"], specs["state"]["step"]],
                                            rules, mesh, dt)
        parts["batch"] = shd.tree_local_bytes(specs["batch"], rules, mesh, dt)
    else:
        parts["params"] = shd.tree_local_bytes(specs["params"], rules, mesh, dt)
        if shape.kind == "prefill":
            parts["batch"] = shd.tree_local_bytes(specs["batch"], rules, mesh, dt)
        else:
            parts["caches"] = shd.tree_local_bytes(specs["dstate"]["caches"], rules, mesh, dt)
            parts["batch"] = shd.tree_local_bytes(
                {k: v for k, v in specs["dstate"].items() if k != "caches"}, rules, mesh, dt)
    return {k: float(v) for k, v in parts.items()}


def run_cell(arch: str, shape_name: str, mesh: str = "one", *, microbatches: int = 0,
             overrides: Optional[Dict[str, Dict[str, Any]]] = None,
             cfg=None, shape=None) -> Dict[str, Any]:
    """The dry-run record of one cell; ``overrides`` (parsed ``--set``
    values) apply for the cell only; ``cfg`` and ``shape`` stand in for the
    named config and shape (reduced cells)."""
    if microbatches <= 0:
        microbatches = default_microbatches(arch, shape_name)
    m = get_mesh(mesh) if isinstance(mesh, str) else mesh
    with _temp_settings(overrides or {}):
        rec: Dict[str, Any] = {
            "arch": arch, "shape": shape_name, "mesh": m.name, "chips": m.size,
            "settings": current_settings(), "microbatches": microbatches, "status": "ok",
        }
        cfg = cfg or get_config(arch)
        shape = shape or SHAPES[shape_name]
        runs, reason = cell_status(cfg, shape)
        if not runs:
            rec["status"] = "skip"
            rec["reason"] = reason
            return rec
        applied, undo = _redeploy_stored_cell_configs(f"{arch}/{shape_name}/{m.name}")
        if applied:
            rec["stored_cell_settings"] = applied
            rec["settings"] = current_settings()  # refresh: reflect the redeploy
        try:
            if m.size == 1:
                _plan(rec, arch, shape_name, cfg, shape, microbatches, m, None)
            else:
                with traced_group(m) as dm:
                    _plan(rec, arch, shape_name, cfg, shape, microbatches, m, dm)
            rec["os_counters"] = os_counters()
        except Exception as e:  # noqa: BLE001 — a failing cell is recorded, the sweep goes on
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc(limit=25)
        finally:
            undo()
    return rec


def _plan(rec: Dict[str, Any], arch: str, shape_name: str, cfg, shape, microbatches: int,
          m, device_mesh) -> None:
    """The record of a cell on mesh ``m``: one device's, or on a sharded mesh
    (``device_mesh``) rank 0's."""
    t0 = time.perf_counter()
    plan = build_cell(arch, shape_name, m, microbatches=microbatches, cfg=cfg,
                      shape=shape, device_mesh=device_mesh)
    rec["meta"] = dict(plan.meta, hw=HW["name"], hw_fingerprint=HW["fingerprint"])
    ops = {"flash_attention": attn_ops.DISPATCHED, "ssd": ssd_ops.DISPATCHED}
    before = {k: dict(d) for k, d in ops.items()}
    prod = trace(plan, "alloc")
    # each kernel's calls in the step: those a kernel is built for, and those at
    # a local shape none is (traced plain here; they would raise on the card)
    routes = {k: {r: d[r] - before[k][r] for r in d} for k, d in ops.items()}
    t1 = time.perf_counter()
    rec["wall"] = {"production_trace_s": t1 - t0}
    rec["memory"] = {"argument_size_in_bytes": prod["argument_bytes"],
                     "output_size_in_bytes": prod["output_bytes"],
                     "temp_size_in_bytes": prod["temp_bytes"],
                     "alias_size_in_bytes": prod["alias_bytes"]}
    if device_mesh is not None:
        rec["memory"]["state"] = state_bytes(cfg, shape, m)
    rec["per_device_bytes"] = prod["peak_bytes"]
    rec["fits"] = bool(prod["peak_bytes"] < HW["memory_bytes"])
    c, cs, K = extrapolated_counters(arch, shape_name, microbatches, cfg=cfg, shape=shape,
                                     mesh=m, device_mesh=device_mesh)
    rec["wall"]["counter_passes_s"] = time.perf_counter() - t1
    rec["counter_passes"] = {"k1": {k: cs[0][k] for k in COUNTER_KEYS},
                             "k2": {k: cs[1][k] for k in COUNTER_KEYS}, "units": K}
    b = shape.global_batch // microbatches
    impl = attn_ops.attention_settings.settings_for(
        attn_ops.workload_signature(b, shape.seq_len, shape.seq_len, cfg.hd or 1))["impl"]
    if impl == "kernel" and not cfg.attn_free and shape.kind != "decode":
        adj = attention_adjustment(cfg, shape, microbatches, m)
        c["bytes_accessed"] = max(0.0, c["bytes_accessed"] - adj["delta_bytes"])
        rec["kernel_adjustment"] = adj
    if device_mesh is not None:
        c["kernels"] = routes
    rec["counters"] = c
    peak = HW["peak_flops_bf16"] if dtype_of(cfg) == torch.bfloat16 else HW["peak_flops_f32"]
    rec["roofline"] = {
        "compute_s": c["flops"] / peak,
        "memory_s": c["bytes_accessed"] / HW["hbm_bw"],
        "collective_s": c["collective_bytes"] / link_bw(m),
    }
    terms = rec["roofline"]
    rec["bottleneck"] = max(terms, key=terms.get)
    step_s = max(terms.values())
    rec["step_time_bound_s"] = step_s
    mf = plan.meta["model_flops"] / rec["chips"]   # per-device useful flops
    rec["useful_flops_ratio"] = mf / max(c["flops"], 1.0)
    # useful model flops over peak for the bound's step time (the hillclimb's score)
    rec["roofline_fraction"] = (mf / peak) / max(step_s, 1e-12)


def cell_path(out_dir: Path, arch: str, shape: str, mesh: str) -> Path:
    return Path(out_dir) / f"{arch}__{shape}__{mesh}.json"


def main() -> int:
    ap = argparse.ArgumentParser(description="the port's dry-run sweep")
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=[*MESHES, "all"], default="one")
    ap.add_argument("--all", action="store_true", help="sweep every cell")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = per-arch default (4 for >40B train cells)")
    ap.add_argument("--set", action="append", default=[], metavar="comp.key=val",
                    help="MLOS tunable override (repeatable)")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--tag", default="", help="suffix for result files (perf experiments)")
    ap.add_argument("--reduced", action="store_true",
                    help="trace each config's reduced() at a small shape (seq 64, two rows a "
                         "data shard): a smoke run that fits any host")
    ap.add_argument("--store", default=None,
                    help="config store root whose cell entries are redeployed (default: the "
                         "repo's)")
    args = ap.parse_args()

    if args.store:
        configstore.set_default_store(configstore.ConfigStore(args.store))
    for s in args.set:
        apply_overrides(parse_override(s))

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else ALL_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    if not (args.all or args.arch or args.shape):
        ap.error("pass --all or --arch/--shape")

    n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                tag = f"{mesh}{('__' + args.tag) if args.tag else ''}"
                path = cell_path(out_dir, arch, shape, tag)
                if path.exists() and not args.force:
                    rec = json.loads(path.read_text())
                    print(f"[cached] {arch:24s} {shape:12s} {mesh:6s} {rec['status']}")
                    continue
                t0 = time.perf_counter()
                small = {}
                if args.reduced:
                    m = get_mesh(mesh)
                    rows = 2 * m.sizes.get("data", 1) * m.sizes.get("pod", 1)
                    small = {"cfg": get_config(arch).reduced(),
                             "shape": Shape(shape, SHAPES[shape].kind, 64, rows)}
                rec = run_cell(arch, shape, mesh, microbatches=args.microbatches, **small)
                rec["tunable_overrides"] = args.set
                # whole or not at all: a reader may be waiting for the file
                tmp = path.with_name(path.name + ".tmp")
                tmp.write_text(json.dumps(rec, indent=1))
                tmp.replace(path)
                dt = time.perf_counter() - t0
                msg = rec["status"]
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    msg += (f" mem={rec['per_device_bytes']/1e9:.2f}GB"
                            f" compute={r['compute_s']*1e3:.2f}ms"
                            f" memory={r['memory_s']*1e3:.2f}ms"
                            f" coll={r['collective_s']*1e3:.2f}ms"
                            f" bound={rec['bottleneck'].split('_')[0]}")
                elif rec["status"] == "error":
                    n_err += 1
                    msg += " " + rec["error"][:120]
                print(f"[{dt:6.1f}s] {arch:24s} {shape:12s} {mesh:6s} {msg}", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
