"""The port's dry-run, roofline and hillclimb layer (``repro_torch.launch.
{shapes,specs,dryrun,adjust,roofline,perf}``, ``core.telemetry.op_counters``)
against the reference's (``repro.launch``).

What must be equal is equal exactly: the shapes, ``cell_status``,
``depth_units``, ``flops_param_count`` and ``model_flops`` of all 40 cells,
the record's keys (the reference's less those that correct XLA-CPU
artefacts), the roofline table and the hillclimb cells on canned records,
and the hillclimb's path on canned dry-run records.  The traces run on
``meta`` tensors at reduced size: their matmul FLOPs equal a hand count,
and the k = 1, 2 extrapolation equals a trace at full depth, exactly.
Beside the reference's ``hlo_counters`` (XLA's cost analysis of the same
reduced cell) the port counts 0.80–1.00 of the FLOPs: ``FlopCounterMode``
counts the products, XLA adds every elementwise and transcendental
operation, which at these reduced widths is up to a sixth of its count
(measured 0.83–0.99 on the cells below).  No full-size cell is traced here.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.compat import make_mesh
from repro.configs import get_config as jget_config
from repro.core import configstore as jconfigstore
from repro.core.telemetry import hlo_counters
from repro.launch import perf as jperf
from repro.launch import roofline as jroofline
from repro.launch import shapes as jshapes
from repro.launch import specs as jspecs
from repro.launch import tuning as jtuning
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import configstore
from repro_torch.core.telemetry import op_counters
from repro_torch.launch import adjust, dryrun, perf, roofline, shapes, specs
from repro_torch.launch.mesh import HW, MESHES, traced_group
from repro_torch.models.layers import spec_leaves
from torch_threads import one_thread

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in ALL_ARCHS for s in shapes.SHAPES]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def small(kind: str, seq: int = 64, batch: int = 2) -> shapes.Shape:
    name = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    return shapes.Shape(name, kind, seq, batch)


# --------------------------------------------------------------- the numbers
def test_the_shapes_are_the_references():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.all_cells() == jshapes.all_cells()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_numbers_equal_the_references(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    sh, jsh = shapes.SHAPES[shape], jshapes.SHAPES[shape]
    assert shapes.cell_status(cfg, sh) == jshapes.cell_status(jcfg, jsh)
    assert specs.depth_units(cfg) == jspecs.depth_units(jcfg)
    assert specs.flops_param_count(cfg) == jspecs.flops_param_count(jcfg)
    assert specs.model_flops(cfg, sh) == jspecs.model_flops(jcfg, jsh)
    for k in (1, 2):
        assert specs.scaled_config(cfg, k).param_count() == \
            jspecs.scaled_config(jcfg, k).param_count()


@pytest.mark.parametrize("arch,shape", [("starcoder2-15b", "long_500k"),
                                        ("deepseek-67b", "train_4k"),
                                        ("llama-3.2-vision-11b", "prefill_32k")])
def test_build_cell_allocates_no_byte(arch, shape):
    """Full-size arguments as meta tensors: shapes and dtypes of the specs,
    no storage."""
    plan = specs.build_cell(arch, shape)
    ts = [t for t in _tensors(plan.args)]
    assert ts and all(t.device.type == "meta" for t in ts)
    cfg = get_config(arch)
    spec_bytes = sum(math.prod(p.shape) * torch.empty((), dtype=p.with_dtype(torch.bfloat16))
                     .element_size() for tree in specs.cell_specs(cfg, shapes.SHAPES[shape])
                     .values() for p in spec_leaves(tree))
    storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in ts}
    assert sum(storages.values()) == spec_bytes
    assert plan.meta["model_flops"] == specs.model_flops(cfg, shapes.SHAPES[shape])
    # a sharded cell is built inside the fake group: meta DTensors whose local
    # shards are one device's state, and nothing allocated either
    with pytest.raises(ValueError, match="traced_group"):
        specs.build_cell(arch, shape, "single")
    with traced_group(MESHES["single"]) as dm:
        plan = specs.build_cell(arch, shape, "single", device_mesh=dm)
        local = [t.to_local() for t in _tensors(plan.args)]
        assert local and all(t.device.type == "meta" for t in local)
        storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in local}
        assert sum(storages.values()) == sum(
            dryrun.state_bytes(cfg, shapes.SHAPES[shape], MESHES["single"]).values())
        assert plan.meta["chips"] == 256 and plan.meta["model_flops"] == \
            specs.model_flops(cfg, shapes.SHAPES[shape])


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


# ------------------------------------------------------------------ traces
def test_op_counters_count_operands_views_and_live_storage():
    a = torch.empty((64, 128), device="meta", dtype=torch.bfloat16)
    b = torch.empty((128, 32), device="meta", dtype=torch.bfloat16)
    table = torch.empty((1000, 32), device="meta", dtype=torch.float32)
    ids = torch.empty((4, 8), device="meta", dtype=torch.long)

    def f(a, b, table, ids):
        c = a @ b                       # 2·64·128·32 FLOPs; 16384 + 8192 + 4096 bytes
        d = c.float().t()               # a copy (4096 + 8192), then a view (0)
        del c                           # freed: its 4096 bytes leave the live set
        e = torch.nn.functional.embedding(ids, table)   # reads 4·8 rows, not 1000
        return d * 2, e

    c = op_counters(f, a, b, table, ids)
    assert c["flops"] == 2 * 64 * 128 * 32
    rows = 4 * 8 * 32 * 4
    assert c["bytes_accessed"] == (16384 + 8192 + 4096) + (4096 + 8192) + (8 * 32 + 2 * rows) \
        + (8192 + 8192)
    args = 16384 + 8192 + 1000 * 32 * 4 + 32 * 8
    assert c["argument_bytes"] == args and c["collective_bytes"] == 0
    # peak at the end: the arguments, c's f32 copy, e and d * 2 (c was freed,
    # else it would add its 4096)
    assert c["peak_bytes"] == args + 8192 + rows + 8192
    assert c["output_bytes"] == 8192 + rows and c["alias_bytes"] == 0
    with pytest.raises(ValueError, match="meta"):
        op_counters(f, torch.ones(2), b, table, ids)


def test_traced_flops_of_a_reduced_dense_prefill_equal_a_hand_count():
    cfg = get_config("olmo-1b").reduced()
    b, s = 2, 32
    plan = specs.build_cell("olmo-1b", "prefill_32k", cfg=cfg, shape=small("prefill", s, b))
    got = dryrun.trace(plan, "plain")["flops"]
    d, h, k, hd, f, v = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.padded_vocab
    mm = lambda m, n, kk: 2 * m * n * kk
    layer = (mm(b * s, h * hd, d) + 2 * mm(b * s, k * hd, d) + mm(b * s, d, h * hd)   # q k v o
             + 2 * mm(b * h * s, s, hd)                                            # QKᵀ and PV
             + 3 * mm(b * s, f, d))                                                # SwiGLU
    assert cfg.mlp == "swiglu" and got == cfg.n_layers * layer + mm(b, v, d)        # last logits


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-780m", "seamless-m4t-medium",
                                  "llama-3.2-vision-11b", "olmoe-1b-7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_the_k1_k2_extrapolation_equals_a_trace_at_full_depth(arch, kind):
    cfg = specs.scaled_config(get_config(arch).reduced(), 4).validate()
    shape = small(kind)
    c, _, units = dryrun.extrapolated_counters(arch, shape.name, 1, cfg=cfg, shape=shape)
    full = dryrun.trace(specs.build_cell(arch, shape.name, cfg=cfg, shape=shape), "plain")
    assert units == 4
    assert {key: c[key] for key in dryrun.COUNTER_KEYS} == \
        {key: full[key] for key in dryrun.COUNTER_KEYS}


def _reference_counters(arch, shape, monkeypatch):
    """hlo_counters of the reference's cell at the reduced config and shape,
    its counter settings (unrolled layers and attention, chunked SSD), on a
    one-device mesh."""
    jcfg = jget_config(arch).reduced()
    monkeypatch.setattr(jspecs, "get_config", lambda a: jcfg)
    monkeypatch.setattr(jspecs, "SHAPES", {shape.name: jshapes.Shape(*dataclasses.astuple(shape))})
    for comp, kv in {"layer_stack": {"scan_layers": False},
                     "flash_attention": {"impl": "unrolled"},
                     "ssd_kernel": {"impl": "chunked_unrolled"}}.items():
        inst = jtuning.SINGLETONS[comp]
        monkeypatch.setattr(inst, "settings", {**inst.settings, **kv})
    plan = jspecs.build_cell(arch, shape.name, make_mesh((1, 1), ("data", "model")))
    compiled = jax.jit(plan.step, out_shardings=plan.out_shardings,
                       donate_argnums=plan.donate_argnums).lower(*plan.args).compile()
    return hlo_counters(compiled)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-780m", "olmoe-1b-7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_traced_flops_beside_the_references_hlo_counters(arch, kind, monkeypatch):
    shape = small(kind)
    want = _reference_counters(arch, shape, monkeypatch)["flops"]
    got = dryrun.trace(specs.build_cell(arch, shape.name, cfg=get_config(arch).reduced(),
                                        shape=shape), "plain")["flops"]
    assert 0.80 * want <= got <= want, (got, want, got / want)


# -------------------------------------------------------------- adjustment
def test_the_attention_adjustment_counts_qkvo_once_per_forward_call():
    """Never the reference's 15/4 traversals of a fused backward: Q, K, V, O
    once per kernel forward call, two calls a layer under remat "full" (the
    recompute), one under "none"; nothing for a decode."""
    cfg = get_config("olmo-1b").reduced()
    shape = small("train", 128, 4)
    adj = adjust.attention_adjustment(cfg, shape, microbatches=2)
    q = 2 * 128 * cfg.n_heads * cfg.hd * 4          # microbatch of 2 rows, f32
    kv = 2 * 128 * cfg.n_kv_heads * cfg.hd * 4
    assert adj["bytes_ideal"] == 2 * q + 2 * kv
    assert adj["attn_calls"] == cfg.n_layers * 2 * 2
    assert adj["delta_bytes"] == adj["attn_calls"] * (adj["bytes_plain"] - adj["bytes_ideal"]) > 0
    with dryrun._temp_settings({"torch_layer_stack": {"remat": "none"}}):
        assert adjust.attention_adjustment(cfg, shape, 2)["attn_calls"] == cfg.n_layers * 2
    assert adjust.attention_adjustment(cfg, small("decode"))["delta_bytes"] == 0.0
    assert adjust.attention_adjustment(get_config("mamba2-780m").reduced(),
                                       small("prefill"))["attn_calls"] == 0


def test_a_record_takes_the_adjustment_off_the_traced_bytes():
    cfg = get_config("starcoder2-15b").reduced()
    shape = small("prefill", 128)
    rec = dryrun.run_cell("starcoder2-15b", shape.name, cfg=cfg, shape=shape)
    c, _, _ = dryrun.extrapolated_counters("starcoder2-15b", shape.name, 1, cfg=cfg,
                                           shape=shape)
    adj = rec["kernel_adjustment"]
    assert rec["counters"]["bytes_accessed"] == c["bytes_accessed"] - adj["delta_bytes"]
    assert rec["counters"]["flops"] == c["flops"]
    r = rec["roofline"]
    assert r["compute_s"] == c["flops"] / HW["peak_flops_f32"]       # a float32 cell
    assert r["memory_s"] == rec["counters"]["bytes_accessed"] / HW["hbm_bw"]
    assert rec["step_time_bound_s"] == max(r.values()) and r["collective_s"] == 0.0
    with dryrun._temp_settings({"torch_flash_attention": {"impl": "naive"}}):
        plain = dryrun.run_cell("starcoder2-15b", shape.name, cfg=cfg, shape=shape)
    assert "kernel_adjustment" not in plain


# ------------------------------------------------------------------ records
def _rec_keys(path: Path) -> set:
    """Every key a module writes into ``rec``: ``rec["k"] = ...`` and the
    literal it starts from."""
    keys = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) \
                and node.value.id == "rec" and isinstance(node.ctx, ast.Store) \
                and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and isinstance(node.value, ast.Dict):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(isinstance(t, ast.Name) and t.id == "rec" for t in targets):
                keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
    return keys


XLA_ONLY = {"scanned_counters", "f32_shadow_bytes", "tpu_memory_estimate_bytes",
            "fits_16gb_tpu_est"}
RENAMED = {"fits_16gb": "fits", "pallas_adjustment": "kernel_adjustment"}


def test_the_record_keys_are_the_references_less_the_xla_ones():
    ref = _rec_keys(ROOT / "src" / "repro" / "launch" / "dryrun.py")
    want = {RENAMED.get(k, k) for k in ref - XLA_ONLY}
    assert _rec_keys(ROOT / "src" / "repro_torch" / "launch" / "dryrun.py") == want
    cfg = get_config("olmo-1b").reduced()
    rec = dryrun.run_cell("olmo-1b", "prefill_32k", cfg=cfg, shape=small("prefill"))
    assert rec["status"] == "ok"
    assert set(rec) == want - {"reason", "error", "traceback", "stored_cell_settings",
                               "tunable_overrides"}
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "temp_size_in_bytes", "alias_size_in_bytes"}
    assert rec["per_device_bytes"] == rec["memory"]["argument_size_in_bytes"] + \
        rec["memory"]["temp_size_in_bytes"] and rec["fits"]
    skip = dryrun.run_cell("olmo-1b", "long_500k")
    assert skip["status"] == "skip" and skip["reason"]


def test_production_meshes_give_each_devices_state():
    """A cell on ``single`` is rank 0's traced program, with the record's full
    key set (reduced here: no full-size cell is traced on this host); its
    state is the FSDP arithmetic of the full config."""
    cfg = get_config("olmo-1b")
    rec = dryrun.run_cell("olmo-1b", "train_4k", "single", cfg=cfg.reduced(),
                          shape=small("train", 64, 32))
    ref = _rec_keys(ROOT / "src" / "repro" / "launch" / "dryrun.py")
    assert rec["status"] == "ok" and rec["chips"] == 256, rec.get("traceback")
    assert set(rec) == {RENAMED.get(k, k) for k in ref - XLA_ONLY} - {
        "reason", "error", "traceback", "stored_cell_settings", "tunable_overrides"}
    assert set(rec["memory"]["state"]) == {"params", "opt", "batch"}
    assert rec["per_device_bytes"] >= rec["memory"]["argument_size_in_bytes"] >= \
        sum(rec["memory"]["state"].values())
    coll = rec["counters"]["collectives"]
    assert coll["all_gather"]["axes"]["data"] > 0 and coll["reduce_scatter"]["axes"]["data"] > 0
    assert rec["roofline"]["collective_s"] == rec["counters"]["collective_bytes"] / \
        HW["internode_bw"] > 0
    mf = rec["meta"]["model_flops"] / 256
    assert rec["useful_flops_ratio"] == mf / rec["counters"]["flops"]
    # FSDP + TP over 256 devices: about 1/256 of (bf16 params + f32 m, v);
    # the pod axis halves each device's optimizer state again on multi
    full = dryrun.state_bytes(cfg, shapes.SHAPES["train_4k"], MESHES["single"])
    assert full["params"] + full["opt"] == pytest.approx(10 * cfg.param_count() / 256, rel=0.05)
    multi = dryrun.state_bytes(cfg, shapes.SHAPES["train_4k"], MESHES["multi"])
    assert multi["opt"] == pytest.approx(full["opt"] / 2, rel=0.05)
    dec = dryrun.state_bytes(get_config("mamba2-780m"), shapes.SHAPES["long_500k"],
                             MESHES["multi"])
    assert set(dec) == {"params", "caches", "batch"}


def test_the_cli_writes_a_record(tmp_path):
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b",
                          "--shape", "decode_32k", "--mesh", "multi", "--reduced",
                          "--out", str(tmp_path), "--store", str(tmp_path / "store")],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "olmo-1b__decode_32k__multi.json").read_text())
    assert rec["status"] == "ok" and rec["tunable_overrides"] == [] and rec["chips"] == 512
    assert set(rec["memory"]["state"]) == {"params", "caches", "batch"}
    assert rec["counters"]["collectives"]["all_reduce"]["count"] > 0
    assert "ok mem=" in out.stdout


# -------------------------------------------------------- roofline formulas
@pytest.mark.parametrize("s,window", [(7, 0), (9, 3), (16, 16), (20, 5), (5, 40)])
def test_attention_work_counts_the_unmasked_pairs(s, window):
    pairs = sum(1 for i in range(s) for j in range(s) if j <= i and (not window or i - j < window))
    bytes_moved, flops = roofline.attention_work(2, s, 4, 2, 8, 2, window)
    assert flops == 4 * 8 * 2 * 4 * pairs
    assert bytes_moved == 2 * 8 * (2 * 2 * s * 4 + 2 * 2 * s * 2)


def test_bound_ms_takes_the_larger_term():
    assert roofline.bound_ms(3.35e12, 0.0, 1e15) == (1e3, "bytes")
    assert roofline.bound_ms(0.0, 2e15, 1e15) == (2e3, "operations")


# ----------------------------------------------------------- table and cells
def _canned():
    """Records in both packages' shapes: the reference's keys beside the
    port's."""
    out = []
    for i, (arch, shape) in enumerate(CELLS[:12]):
        if shape == "long_500k" and not get_config(arch).sub_quadratic:
            out.append({"arch": arch, "shape": shape, "status": "skip"})
            continue
        terms = {"compute_s": 0.001 * (i + 1), "memory_s": 0.0015 * (12 - i),
                 "collective_s": 0.0001 * (i % 3)}
        out.append({"arch": arch, "shape": shape, "status": "error" if i == 5 else "ok",
                    "roofline": terms, "bottleneck": max(terms, key=terms.get),
                    "per_device_bytes": 1e9 * (i + 1), "tpu_memory_estimate_bytes": 1e9 * (i + 1),
                    "fits_16gb": i < 10, "fits_16gb_tpu_est": i < 10, "fits": i < 10,
                    "useful_flops_ratio": 0.5 + 0.01 * i, "roofline_fraction": 0.02 * (i + 1)})
    return out


def _cols(table: str):
    """Rows split into cells, the memory and fit columns left out (the
    reference prints its TPU estimate beside the measured bytes and fits
    16 GB; the port prints its bytes and fits the card)."""
    rows = [r.replace("MODEL/HLO flops", "MODEL/traced flops").split("|")
            for r in table.splitlines()]
    return [r[:4] + r[6:] for r in rows]


def test_render_table_and_pick_hillclimb_cells_equal_the_references():
    cells = _canned()
    port_cells = [dict(c, mesh="one") for c in cells]
    ref_cells = [dict(c, mesh="single") for c in cells]
    got, want = roofline.render_table(port_cells, "one"), jroofline.render_table(ref_cells,
                                                                                 "single")
    assert _cols(got) == _cols(want)
    ok_rows = [r for r in got.splitlines()[2:] if "| ok |" in r]
    assert all(f"{c['per_device_bytes'] / 1e9:.1f} GB" in r for c, r in
               zip([c for c in port_cells if c["status"] == "ok"], ok_rows))
    assert roofline.pick_hillclimb_cells(port_cells, "one") == \
        jroofline.pick_hillclimb_cells(ref_cells)
    sharded = dict(port_cells[0], mesh="single", counters={"collective_bytes": 2.5e9})
    table = roofline.render_table([sharded, dict(cells[5], mesh="single")], "single")
    head, _, row, error = table.splitlines()
    assert head.endswith("| coll bytes |") and row.endswith("| 2.50 GB |")
    assert row.startswith(f"| {sharded['arch']} | {sharded['shape']} | ok |") and "–" not in row
    assert all(len(r.split("|")) == len(head.split("|")) for r in (row, error))


def test_load_cells_skips_experiment_files(tmp_path):
    for name in ("a__b__one", "a__b__one__hc1", "c__d__one"):
        (tmp_path / f"{name}.json").write_text(json.dumps({"status": "skip", "mesh": "one"}))
    assert [c["_file"] for c in roofline.load_cells(str(tmp_path))] == ["a__b__one.json",
                                                                        "c__d__one.json"]
    assert [c["_file"] for c in roofline.load_cells(str(tmp_path), "hc1")] == [
        "a__b__one__hc1.json"]


# ---------------------------------------------------------------- hillclimb
EFFECTS = {"kernel-flash": (1.0, 0.6), "remat-dots": (0.8, 1.05), "remat-none": (0.74, 0.97),
           "capacity-1.0": (1.0, 1.0), "block-q-128": (0.99, 0.99), "loss-chunk-512": (1.0, 1.0),
           "microbatch-8": (1.0, 0.9), "microbatch-1": (1.0, 1.0)}


def _canned_dryrun(candidates, mem=1e9):
    """A stand-in ``_dryrun``: each candidate scales (compute, memory) of a
    memory-bound baseline; the port's and the reference's set strings map to
    one name by their candidate's position."""
    by_set = {s: c["name"] for c in candidates for s in c.get("sets", [])}
    port_names = [c["name"] for c in perf.CANDIDATES]
    names = dict(zip([c["name"] for c in candidates], port_names))
    calls = []

    def fake(arch, shape, mesh, tag, sets, microbatches, out, *rest):
        moves = [names[by_set[s]] for s in sets]
        if microbatches:
            moves.append(f"microbatch-{microbatches}")
        calls.append(moves)
        compute, memory = 1.0, 2.0
        for m in moves:
            compute, memory = compute * EFFECTS[m][0], memory * EFFECTS[m][1]
        terms = {"compute_s": compute, "memory_s": memory, "collective_s": 0.0}
        return {"status": "ok", "roofline": terms, "bottleneck": max(terms, key=terms.get),
                "per_device_bytes": mem, "fits_16gb": mem < 16e9, "fits": True,
                "roofline_fraction": 0.1 / max(terms.values())}

    return fake, calls, names


def test_the_hillclimb_follows_the_references_on_canned_records(tmp_path, monkeypatch):
    pfake, pcalls, _ = _canned_dryrun(perf.CANDIDATES)
    jfake, jcalls, names = _canned_dryrun(jperf.CANDIDATES)
    monkeypatch.setattr(perf, "_dryrun", pfake)
    monkeypatch.setattr(jperf, "_dryrun", jfake)
    old = jconfigstore.set_default_store(jconfigstore.ConfigStore(tmp_path / "ref_store"))
    try:
        want = jperf.hillclimb("olmoe-1b-7b", "train_4k", "single", out=str(tmp_path),
                               log_path=str(tmp_path / "ref.json"))
    finally:
        jconfigstore.set_default_store(old)
    got = perf.hillclimb("olmoe-1b-7b", "train_4k", "one", out=str(tmp_path),
                         log_path=str(tmp_path / "port.json"), store=str(tmp_path / "store"))
    assert pcalls == jcalls and len(pcalls) > 2
    assert [e["name"] for e in got["log"][1:]] == [names[e["name"]] for e in want["log"][1:]]
    assert [e.get("verdict") for e in got["log"]] == [e.get("verdict") for e in want["log"]]
    assert got["best"]["terms"] == want["best"]["terms"]
    assert got["speedup_step_bound"] == want["speedup_step_bound"]
    # the winners, under the cell and the card's fingerprint, wherever this ran
    assert len(got["persisted_contexts"]) == len(want["persisted_contexts"]) > 0
    entries = [e for p in (tmp_path / "store").glob("*.json")
               for e in json.loads(p.read_text())["entries"]]
    assert {e["context"]["hardware"] for e in entries} == {HW["fingerprint"]}
    assert {e["context"]["workload"] for e in entries} == {"olmoe-1b-7b/train_4k/one"}
    assert configstore.hardware_fingerprint() != HW["fingerprint"]      # this is the CPU


def test_the_hillclimb_keeps_out_what_does_not_fit_the_card(tmp_path, monkeypatch):
    fake, _, _ = _canned_dryrun(perf.CANDIDATES, mem=HW["memory_bytes"] + 1)
    base = fake("a", "b", "one", "", [], None, "")
    monkeypatch.setattr(perf, "_dryrun", lambda *a: (dict(base) if not a[4] and a[5] is None
                                                      else fake(*a)))
    got = perf.hillclimb("olmo-1b", "train_4k", "one", out=str(tmp_path),
                         log_path=str(tmp_path / "p.json"), store=str(tmp_path / "store"))
    assert got["best"]["sets"] == [] and got["persisted_contexts"] == []
    assert all(e["outcome"].startswith("refuted") for e in got["log"][1:])


def test_the_new_modules_stand_alone():
    """The slice's modules are in the port's package walk (so the isolation
    checks of tests/test_torch_isolation.py cover them) and import nothing
    of jax or the reference."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    new = {f"repro_torch.launch.{m}" for m in ("shapes", "mesh", "specs", "dryrun", "adjust",
                                               "roofline", "perf")}
    new |= {"repro_torch.parallel.sharding", "repro_torch.parallel.collectives",
            "repro_torch.optim.compress", "repro_torch.runtime.elastic",
            "repro_torch.bench.roofline_table"}
    assert new <= names
    for name in new:
        path = ROOT / "src" / (name.replace(".", "/") + ".py")
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in mods), name
