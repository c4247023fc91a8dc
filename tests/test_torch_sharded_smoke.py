"""chip_smoke's sharded dry-run phases, rehearsed on the CPU.

``dryrun-check-sharded`` runs rank 0's local program of three cells of the
production mesh ``single`` on the card inside a fake process group; here
the same code runs on the CPU at reduced size on a (data 2, model 4) mesh:
the arguments are rank 0's shards placed by the rules, the record is the
sharded dry-run's, and the attention calls a step makes are what the phase
holds the kernel's launches to.  The background sweep's sharded cells and
hillclimb are checked on canned records (``check_dryrun_sharded``).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import shapes, specs
from repro_torch.launch.mesh import HW, Mesh, traced_group
from repro_torch.models.layers import spec_leaves
from repro_torch.parallel import sharding as shd
from torch_threads import one_thread

ROOT = Path(__file__).resolve().parents[1]
MESH = Mesh("t", (("data", 2), ("model", 4)))
KINDS = {"train_4k": "train", "prefill_32k": "prefill", "decode_32k": "decode"}


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
        yield cs
    finally:
        sys.path.remove(str(ROOT))


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setitem(launch_mesh.MESHES, "t", MESH)
    with one_thread():
        yield


def _cell(shape_name):
    return shapes.Shape(shape_name, KINDS[shape_name], 64, 8)


@pytest.mark.parametrize("arch,shape_name", [("olmo-1b", "prefill_32k"),
                                             ("deepseek-67b", "decode_32k"),
                                             ("olmoe-1b-7b", "train_4k")])
def test_the_phase_runs_rank_0s_program_and_counts_its_attention_calls(chip_smoke, arch,
                                                                       shape_name, monkeypatch):
    """The phase's path on the CPU: its record is the sharded dry-run's, and
    the step calls attention as often as the phase holds the card's launches
    to (on the CPU the wrapper takes the plain version, so the calls are
    counted at the wrapper)."""
    calls = []
    wrapped = fa.flash_attention

    def counting(q, *a, **kw):
        calls.append(tuple(q.shape))
        return wrapped(q, *a, **kw)

    counting.launches = 0
    monkeypatch.setattr(fa, "flash_attention", counting)
    cfg, shape = get_config(arch).reduced(), _cell(shape_name)
    out = chip_smoke.dryrun_sharded_path("cpu", arch, shape_name, "t", cfg=cfg, shape=shape)
    rec = out["record"]
    assert rec["status"] == "ok" and rec["mesh"] == "t" and rec["chips"] == 8
    none = {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}       # no launch off the card
    assert out["step_launches"] == out["launches"] == none and out["calls"] == []
    # one pass for the record's production trace, two for its counters (k = 1,
    # 2 depth units), one for each of the phase's two steps: count the last
    n = chip_smoke.sharded_attention_calls(cfg, shape, rec["microbatches"])
    assert n == (0 if shape.kind == "decode" else
                 cfg.n_layers * (2 if shape.kind == "train" else 1))
    if n:
        assert len(calls) >= 2 * n and calls[-n:] == calls[-2 * n:-n]
        b, s = shape.global_batch // 2, shape.seq_len      # this rank's rows, every position
        assert {c[:2] for c in calls[-n:]} == {(b, s)}


def test_rank_0s_arguments_are_its_shards(chip_smoke):
    cfg, shape = get_config("deepseek-67b").reduced(), _cell("decode_32k")
    rules = specs.cell_rules(shape, MESH)
    with traced_group(MESH, "cpu") as dm:
        args = chip_smoke.sharded_args(cfg, shape, MESH, rules, dm, "cpu")
        tree = specs.cell_specs(cfg, shape)
        for name in tree:
            for p, t in zip(spec_leaves(tree[name]), _leaves(args[name])):
                assert tuple(t.shape) == p.shape
                assert tuple(t.to_local().shape) == shd.local_shape(p, rules, MESH)
                assert t.placements == shd.placements_for(p, rules, dm)
        assert (args["dstate"]["pos"].to_local() == shape.seq_len - 1).all()
        tok = args["dstate"]["token"].to_local()
        assert tok.dtype == torch.long and 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


# ------------------------------------------------------ the background sweep
def _records(tmp_path, chip_smoke, fault=None):
    (tmp_path / "dryrun").mkdir()
    (tmp_path / "store_sharded").mkdir()
    for arch, shape in chip_smoke.DRYRUN_SHARDED:
        for mesh in chip_smoke.DRYRUN_SHARDED_MESHES:
            opt = 4e9 if mesh == "single" else 2e9
            rec = {"status": "ok", "chips": 256 if mesh == "single" else 512,
                   "per_device_bytes": 1e10, "fits": True, "bottleneck": "memory_s",
                   "roofline": {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5},
                   "counters": {"collectives": {"all_gather": {"count": 3, "bytes": 1e9}}},
                   "step_time_bound_s": 2.0, "useful_flops_ratio": 0.5,
                   "roofline_fraction": 0.1,
                   "memory": {"state": {"params": 1e9, "opt": opt, "batch": 1e6}}}
            if (arch, shape, mesh) == ("olmoe-1b-7b", "train_4k", "multi"):
                if fault == "no_collective":
                    rec["roofline"]["collective_s"] = 0.0
                elif fault == "opt_not_halved":
                    rec["memory"]["state"]["opt"] = opt * 2
                elif fault == "error":
                    rec = {"status": "error", "error": "x"}
            if not (fault == "missing" and mesh == "multi" and arch == "olmo-1b"):
                (tmp_path / "dryrun" / f"{arch}__{shape}__{mesh}.json").write_text(
                    json.dumps(rec))
    arch, shape, mesh, _ = chip_smoke.DRYRUN_SHARDED_HILLCLIMB
    hw = "cpu:x86_64:x1" if fault == "cpu_entry" else HW["fingerprint"]
    entry = {"context": {"component": "torch_layer_stack", "workload": f"{arch}/{shape}/{mesh}",
                         "hardware": hw, "sw": "x"}, "settings": {"remat": "dots"}}
    (tmp_path / "store_sharded" / "torch_layer_stack.json").write_text(
        json.dumps({"component": "torch_layer_stack", "entries": [entry]}))
    (tmp_path / "perf_sharded.json").write_text(json.dumps(
        {"persisted_contexts": [f"torch_layer_stack@{arch}/{shape}/{mesh}"]}))


def test_the_sharded_sweep_is_checked(chip_smoke, tmp_path):
    _records(tmp_path, chip_smoke)
    out = chip_smoke.check_dryrun_sharded(tmp_path)
    assert len(out["records"]) == 2 * len(chip_smoke.DRYRUN_SHARDED) == 8
    assert len(out["entries"]) == 1


@pytest.mark.parametrize("fault", ["error", "missing", "no_collective", "opt_not_halved",
                                   "cpu_entry"])
def test_the_sharded_sweep_fails_on(chip_smoke, tmp_path, fault):
    _records(tmp_path, chip_smoke, fault)
    with pytest.raises(AssertionError):
        chip_smoke.check_dryrun_sharded(tmp_path)


def test_the_background_job_traces_the_sharded_cells_and_hillclimbs_single(chip_smoke,
                                                                           monkeypatch):
    seen = {}

    class Fake:
        def __init__(self, argv, workdir, *, timeout, env=None):
            seen.update(argv=argv, env=env, timeout=timeout, workdir=workdir)

    monkeypatch.setattr(chip_smoke, "Background", Fake)
    chip_smoke.start_dryrun()
    cmd = seen["argv"][-1]
    for arch, shape in chip_smoke.DRYRUN_SHARDED:
        for mesh in ("single", "multi"):
            assert f"--arch {arch} --shape {shape} --mesh {mesh}" in cmd
    assert "-m repro_torch.launch.perf --arch olmo-1b --shape train_4k --mesh single " \
           "--patience 3" in cmd and "wait $p3" in cmd
    assert seen["env"] == {"CUDA_VISIBLE_DEVICES": ""} and seen["timeout"] <= 1100
    Path(seen["workdir"]).rmdir()
