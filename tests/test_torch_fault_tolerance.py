"""The fault-tolerance twin (``repro_torch.bench.fault_tolerance``) at quick
size on the CPU, its smoke check against the reference's
``benchmarks/check_bench.py::check_fault_tolerance``, and its place in the
runner and the ``training`` campaign grid.

The twin runs once per module (about a minute: six child interpreters and
twelve short in-process runs) into ``tmp_path``; every test reads its JSON.
"""
import copy
import json
import os
import tempfile

import pytest
import torch

from repro_torch.bench import check, fault_tolerance, runner


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Reduced models on a CPU shared with the other test workers: one
    intra-op thread in this process and, through ``OMP_NUM_THREADS``, in
    the child interpreters it starts (eight threads per worker spin
    against each other and slow every worker several-fold)."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench")
    records = fault_tolerance.bench(quick=True, seed=7, device="cpu", out_dir=out)
    return out, json.loads((out / "fault_tolerance.json").read_text()), records


def test_twin_claims_hold_on_the_cpu(twin):
    out, res, records = twin
    check.check_fault_tolerance(expect_quick=True, bench_dir=out)
    tr = res["train"]
    assert res["device"] == "cpu" and tr["kills"] == 2 and tr["bit_identical"]
    assert tr["reexecuted_steps"] >= 1 and len(tr["losses"]) == tr["n_steps"]
    assert (out / "campaign" / "fault-tolerance-7.jsonl").exists()
    assert [(r.metric, r.context.component, r.context.workload) for r in records] == [
        ("recovery_s", "torch_train_checkpoint", "kb2048"),
        ("ckpt_blocked_ms", "torch_train_checkpoint", "kb2048")]


def _mutations(res):
    yield "as run", res
    for path, value in ((("train", "bit_identical"), False), (("train", "restarts"), 0),
                        (("train", "overlap_identical"), False), (("torn", "fell_back"), False),
                        (("campaign", "replayed_completed_evals"), 1),
                        (("campaign", "cells_resumed_exactly"), 0),
                        (("ckpt_overhead", "verdict", "verdict"), "noise"),
                        (("quick",), False)):
        bad = copy.deepcopy(res)
        node = bad
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
        yield "/".join(path), bad


def test_check_matches_the_reference_check(twin, tmp_path, monkeypatch):
    """The port's check and the reference's pass and fail together, on the
    twin's JSON and on each planted defect."""
    from benchmarks import check_bench

    monkeypatch.setattr(check_bench, "BENCH_DIR", tmp_path)
    _, res, _ = twin
    for name, d in _mutations(res):
        (tmp_path / "fault_tolerance.json").write_text(json.dumps(d))
        verdicts = []
        for fn in (lambda: check.check_fault_tolerance(expect_quick=True, bench_dir=tmp_path),
                   lambda: check_bench.check_fault_tolerance(expect_quick=True)):
            try:
                fn()
                verdicts.append(True)
            except AssertionError:
                verdicts.append(False)
        assert verdicts[0] == verdicts[1] == (name == "as run"), name


def test_runner_and_checks_know_the_twin():
    assert "fault_tolerance" in runner.REGISTRY and "fault_tolerance" in check.CHECKS


def test_the_training_grid_names_what_run_training_resolves(monkeypatch):
    """The ``training`` grid's checkpoint cell is the signature the port's
    ``run_training`` resolves for reduced OLMo-1B's state in both dtypes it
    trains in, and its pipeline cells are the signatures the batcher
    resolves for their (batch, seq)."""
    from repro_torch.data import pipeline
    from repro_torch.launch import campaign
    from repro_torch.runtime import checkpoint, train_loop

    seen = []
    real = checkpoint.ckpt_settings.settings_for
    monkeypatch.setattr(checkpoint.ckpt_settings, "settings_for",
                        lambda wl: seen.append(wl) or real(wl))
    for device in ("cpu", "cuda"):
        cfg = campaign.train_config(device)
        state = train_loop.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
        assert checkpoint.workload_signature(checkpoint.state_kb(state)) == "kb2048", device
    with tempfile.TemporaryDirectory() as td:
        train_loop.run_training(campaign.train_config("cpu"), n_steps=1, global_batch=2,
                                seq_len=8, ckpt_dir=td, seed=0, device="cpu")
    assert seen == campaign.GRIDS["training"]["torch_train_checkpoint"]
    assert [pipeline.workload_signature(b, s) for b, s in ((4, 128), (8, 256))] == \
        campaign.GRIDS["training"]["torch_data_pipeline"]
    cells = campaign.grid_cells("training", budget=4, optimizer="bo", seed=0, device="cpu")
    assert [(c.component, c.objective, c.mode) for c in cells] == [
        ("torch_train_checkpoint", "overhead_ms", "min"),
        ("torch_data_pipeline", "batch_ms", "min"), ("torch_data_pipeline", "batch_ms", "min")]


def test_training_grid_runs_on_the_cpu(tmp_path):
    """Every ``training`` cell finishes into a temporary store and journal,
    and a rerun under the same id measures nothing."""
    from repro_torch.core.configstore import ConfigStore
    from repro_torch.launch import campaign

    kw = dict(budget=3, device="cpu", campaign_id="training", reps=1,
              store=ConfigStore(str(tmp_path / "store")), journal_root=tmp_path / "j")
    c, results = campaign.run_grid("training", **kw)
    assert sorted(results) == sorted(c.cell_id for c in campaign.grid_cells(
        "training", budget=3, optimizer="bo", seed=0, device="cpu"))
    assert all(r.evaluations == 3 for r in results.values())
    again, rerun = campaign.run_grid("training", **kw)
    assert again.measure_calls == 0 and all(r.resumed for r in rerun.values())
