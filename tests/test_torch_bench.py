"""The port's serving benchmarks (``repro_torch.bench``), their runner and
gate, their checks, and the ``serving`` campaign grid, on the CPU at
reduced size.

The twins' claims are ``stats.compare`` verdicts over wall-clock samples.
On a CPU shared with other processes, a wall-clock sample of the reduced
model moves by tens of percent between runs, which would make the checks' verdict
assertions flip at random.  So these tests run the servers under a cost
model clock (:class:`CostClock`): the serve loop's clock advances by a fixed
cost per decode step, per prefill and per host fetch, the costs the host
pays on the card, where it sets the pace.  The verdicts then follow the
schedulers' work (decode steps, prefills, syncs) and are reproducible; the
pipeline from replay to record, check and gate is the real one.  Nothing
here measures a speed.  The GP engine's twins (``optimizer_throughput``,
``campaign_sweep``, ``multi_instance``) run at quick size on the CPU; their
checks judge no time either.
"""
from __future__ import annotations

import inspect
import json
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import check_bench as jcheck_bench
from repro.core import baseline as jbaseline
from repro.core import rpi as jrpi
from repro.core import tracking as jtracking
from repro.runtime import online as jonline
from repro_torch.bench import (BENCH_ROOT, campaign_sweep, check, configstore_roundtrip,
                               kernel_autotune, multi_instance, online_tuning,
                               optimizer_throughput, runner, serve_scenarios)
from repro_torch.core import baseline, configstore, rpi, tracking
from repro_torch.core import campaign as tcampaign
from repro_torch.core.baseline import BenchRecord
from repro_torch.launch import campaign as tlaunch
from repro_torch.models import model as M
from repro_torch.runtime import online, serve_loop
from torch_threads import one_thread

ROOT = Path(__file__).resolve().parents[1]


class CostClock:
    """``time.perf_counter`` for the serve loop: seconds charged per model
    call rather than read from the wall, each charge with a seeded 2%
    jitter (with none, repeated samples tie and the median permutation test
    can never reach significance)."""

    DECODE, PREFILL, FETCH = 1e-3, 2e-3, 5e-4

    def __init__(self, seed: int):
        self.now = 0.0
        self.rng = np.random.default_rng(seed)

    def perf_counter(self) -> float:
        return self.now

    def charging(self, fn, cost):
        def wrapped(*args, **kwargs):
            self.now += cost * (1.0 + 0.02 * float(self.rng.standard_normal()))
            return fn(*args, **kwargs)
        return wrapped


@pytest.fixture
def cost_clock(monkeypatch, request):
    clock = CostClock(zlib.crc32(request.node.name.encode()))
    monkeypatch.setattr(serve_loop, "time", types.SimpleNamespace(perf_counter=clock.perf_counter))
    monkeypatch.setattr(M, "decode_step", clock.charging(M.decode_step, clock.DECODE))
    monkeypatch.setattr(M, "prefill", clock.charging(M.prefill, clock.PREFILL))
    monkeypatch.setattr(serve_loop, "_host_fetch",
                        clock.charging(serve_loop._host_fetch, clock.FETCH))
    return clock


@pytest.fixture
def store(tmp_path):
    st = configstore.ConfigStore(tmp_path / "cs")
    old = configstore.set_default_store(st)
    yield st
    configstore.set_default_store(old)


# ------------------------------------------------------------------- twins
def test_serve_scenarios_quick_heavy_tail_passes_its_check(tmp_path, cost_clock):
    res = serve_scenarios.run(quick=True, device="cpu", scenarios=["heavy_tail"], repeats=2,
                              out_dir=tmp_path)
    check.check_serve_scenarios(expect_quick=True, bench_dir=tmp_path)
    written = json.loads((tmp_path / "serve_scenarios.json").read_text())
    assert written == json.loads(json.dumps(res))
    assert written["warmup_replays"] == 2 and written["device"] == "cpu"
    assert written["workload"] == "dense_c128" and written["settings"] == serve_scenarios.SETTINGS
    row = written["scenarios"]["heavy_tail"]
    assert row["n_requests"] == 12 and len(row["gang"]["tokens_per_s"]) == 2
    assert written["heavy_tail_verdict"]["verdict"] == "improved"


def test_serve_scenarios_serves_the_moe_model(tmp_path, cost_clock):
    """``--model olmoe-1b-7b`` from the command line (reduced, float32 on
    the CPU): both schedulers serve the heavy tail's token totals, filed
    under the MoE workload, and the check passes."""
    rc = serve_scenarios.main(["--quick", "--device", "cpu", "--model", "olmoe-1b-7b",
                               "--scenarios", "heavy_tail", "--repeats", "2",
                               "--out-dir", str(tmp_path)])
    check.check_serve_scenarios(expect_quick=True, bench_dir=tmp_path)
    written = json.loads((tmp_path / "serve_scenarios.json").read_text())
    assert rc == 0 and written["model"] == "olmoe-1b-7b" and written["workload"] == "moe_c128"
    assert written["n_layers"] == 2 and written["device"] == "cpu"
    row = written["scenarios"]["heavy_tail"]
    assert row["gang"]["total_tokens"] == row["continuous"]["total_tokens"] > 0


def _reduced_registry(monkeypatch):
    monkeypatch.setitem(runner.REGISTRY, "serve_scenarios", lambda quick, seed, **kw:
                        serve_scenarios.bench(quick, seed, scenarios=["heavy_tail"],
                                              repeats=2, **kw))
    monkeypatch.setitem(runner.REGISTRY, "online_tuning", lambda quick, seed, **kw:
                        online_tuning.bench(quick, seed, budget=4, **kw))


def test_runner_runs_both_twins_checks_and_records_them(tmp_path, cost_clock, monkeypatch):
    """``--quick`` on the CPU: both twins run, their JSON passes check.py,
    and each record lands in the trajectory under this process's ``cpu:``
    context and the port's serve component."""
    _reduced_registry(monkeypatch)
    traj = tmp_path / "trajectory.jsonl"
    rep = runner.run_and_gate(["serve_scenarios", "online_tuning"], quick=True, seed=7,
                              gate=True, tolerance=0.25, window=5, alpha=0.05, device="cpu",
                              trajectory=traj, out_dir=tmp_path)
    assert rep["ok"] and rep["appended"] == 3
    assert {r["verdict"] for r in rep["results"]} == {"no_baseline"}
    rows = list(baseline.BaselineStore(traj).rows())
    assert [(r["benchmark"], r["metric"]) for r in rows] == [
        ("serve_scenarios", "heavy_tail_tokens_per_s"),
        ("serve_scenarios", "heavy_tail_p99_latency_s"),
        ("online_tuning", "post_shift_tokens_per_s")]
    for r in rows:
        assert r["quick"] is True and r["schema"] == baseline.SCHEMA_VERSION
        assert r["context"]["component"] == "torch_serve_batching"
        assert r["context"]["hardware"].startswith("cpu:")
        assert len(r["values"]) >= 2 and all(v > 0 for v in r["values"])
    assert rows[0]["meta"]["vs_gang"]["verdict"] == "improved"
    assert rows[2]["meta"]["promotions"] >= 1
    check.check_online_tuning(expect_quick=True, bench_dir=tmp_path)
    tuned = json.loads((tmp_path / "online_tuning.json").read_text())
    assert tuned["tuned"]["sync_interval"] < online_tuning.SETTINGS_STALE["sync_interval"]
    assert json.loads((tmp_path / "gate_report.json").read_text())["appended"] == 3


def test_runner_gate_fails_on_a_planted_2x_regression(tmp_path, monkeypatch):
    factor = {"x": 1.0}

    def synthetic(quick, seed, **kw):
        rng = np.random.default_rng(seed)
        return [BenchRecord.for_component(
            "synthetic", "lat_ms", (rng.normal(100, 3, 15) * factor["x"]).tolist(),
            "comp", "wl0")]

    monkeypatch.setitem(runner.REGISTRY, "synthetic", synthetic)
    traj = tmp_path / "trajectory.jsonl"

    def gate(seed):
        return runner.run_and_gate(["synthetic"], quick=True, seed=seed, gate=True,
                                   tolerance=0.25, window=5, alpha=0.05, device="cpu",
                                   trajectory=traj, out_dir=tmp_path, smoke=False)

    assert gate(1)["results"][0]["verdict"] == "no_baseline"
    assert gate(2)["results"][0]["verdict"] == "noise"
    factor["x"] = 2.0
    rep = gate(3)
    assert rep["results"][0]["verdict"] == "regressed" and not rep["ok"]
    report = json.loads((tmp_path / "gate_report.json").read_text())
    assert report["results"][0]["verdict"] == "regressed"


def test_runner_cli_lists_the_twins_and_check_rejects_a_bad_record(tmp_path, capsys):
    assert runner.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == ["serve_scenarios", "online_tuning",
                                               "kernel_autotune", "configstore_roundtrip",
                                               "fault_tolerance", "optimizer_throughput",
                                               "campaign_sweep", "multi_instance"]
    bad = {"quick": True, "scenarios": {"heavy_tail": {
        mode: {"tokens_per_s": [1.0, 2.0], "p99_latency_s": [0.1, 0.1], "total_tokens": t}
        for mode, t in (("gang", 10.0), ("continuous", 11.0))}},
        "heavy_tail_verdict": {"verdict": "improved", "candidate_location": 2.0,
                               "baseline_location": 1.0}}
    (tmp_path / "serve_scenarios.json").write_text(json.dumps(bad))
    with pytest.raises(AssertionError):
        check.check_serve_scenarios(bench_dir=tmp_path)


def test_twins_refuse_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (serve_scenarios.run, online_tuning.run, kernel_autotune.run):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(quick=True, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        configstore_roundtrip.run(device="cuda")
    for fn in (serve_scenarios.run, online_tuning.run, kernel_autotune.run,
               configstore_roundtrip.run, kernel_autotune.bench, configstore_roundtrip.bench,
               runner.run_and_gate):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ------------------------------------------------- kernel autotune, store round trip
def test_kernel_autotune_quick_passes_the_references_check(tmp_path, monkeypatch):
    """The twin at quick size on the CPU: the reference's shape, budget,
    seed and optimizer, the port component's tiles; the JSON passes both
    the port's check and the reference's (``check_bench.check_kernel_autotune``)."""
    recs = kernel_autotune.bench(quick=True, device="cpu", out_dir=tmp_path)
    check.check_kernel_autotune(expect_quick=True, bench_dir=tmp_path)
    d = json.loads((tmp_path / "kernel_autotune.json").read_text())
    assert d["shape"] == kernel_autotune.QUICK_SHAPE and len(d["trace"]) == 5
    assert d["space"] == {"impl": ["naive", "scan", "unrolled"], "block_q": [64, 128],
                          "block_kv": [64, 128]}
    assert kernel_autotune.space("cuda")["impl"].choices[-1] == "kernel"
    assert [r.metric for r in recs] == ["tuned_us", "default_us"]
    assert {r.context.component for r in recs} == {"torch_flash_attention"}
    assert recs[0].context.workload == "b1q256k256d64"
    assert recs[0].context.hardware.startswith("cpu:")
    monkeypatch.setattr(jcheck_bench, "BENCH_DIR", tmp_path)     # the reference's own check
    jcheck_bench.check_kernel_autotune(expect_quick=True)


def test_configstore_roundtrip_quick_resolves_in_a_fresh_process(tmp_path, monkeypatch):
    """Two contexts tuned, promoted into a store under the bench directory,
    resolved back by a fresh interpreter that imports only ``repro_torch``
    (under this process's ``cpu:`` fingerprint); the JSON passes both
    checks, and the repository's default store is untouched."""
    default_root = configstore.default_store().root
    before = sorted(default_root.rglob("*.json")) if default_root.exists() else []
    recs = configstore_roundtrip.bench(quick=True, device="cpu", out_dir=tmp_path)
    check.check_configstore_resolve(expect_quick=True, bench_dir=tmp_path)
    monkeypatch.setattr(jcheck_bench, "BENCH_DIR", tmp_path)     # the reference's own check
    jcheck_bench.check_configstore_resolve(expect_quick=True)
    d = json.loads((tmp_path / "configstore_resolve.json").read_text())
    assert d["fresh_process_resolution"] == "ok"
    assert d["fresh_process_hardware"] == configstore.hardware_fingerprint()
    assert [c["workload"] for c in d["contexts"].values()] == ["b1q256k256d64", "b4q512k512d64"]
    assert all(c["best_config"]["impl"] != "kernel" for c in d["contexts"].values())
    assert Path(d["store"]) == tmp_path / "configstore"
    entries = json.loads((tmp_path / "configstore" / "torch_flash_attention.json").read_text())
    assert {e["context"]["hardware"] for e in entries["entries"]} == {
        configstore.hardware_fingerprint()}
    after = sorted(default_root.rglob("*.json")) if default_root.exists() else []
    assert after == before
    assert [r.metric for r in recs] == ["cached_ns_per_lookup", "uncached_first_ms"]
    assert "kernel" in configstore_roundtrip.tuned_space("cuda")["impl"].choices


# --------------------------------------------------------------- serving grid
def test_serving_grid_cell_runs_and_promotes_on_the_cpu(tmp_path, store, cost_clock):
    """One ``serving`` cell, the real measure (a reduced OLMo-1B server run
    of 12 seeded requests) on the CPU: it promotes under this process's
    ``cpu:`` context, the server then resolves the promoted settings, and a
    rerun under the same id measures nothing."""
    cells = tlaunch.grid_cells("serving", budget=2, optimizer="rs", seed=3, device="cpu")
    assert [c.workload for c in cells] == ["reduced_c128", "reduced_c512"]
    cell = cells[0]
    camp = tcampaign.Campaign([cell], tlaunch.build_measure(device="cpu"), campaign_id="s",
                              store=store, journal_root=tmp_path / "j")
    r = camp.run()[cell.cell_id]
    assert r.evaluations == 2 and r.promoted
    entry = store.resolve_entry(cell.context())
    assert entry["context"]["hardware"].startswith("cpu:")
    assert entry["settings"] == r.best_config
    assert serve_loop.serve_settings.settings_for(cell.workload) == r.best_config
    assert store.get_override(cell.component, cell.workload) is None   # the measure cleaned up
    again = tcampaign.Campaign([cell], tlaunch.build_measure(device="cpu"), campaign_id="s",
                               store=store, journal_root=tmp_path / "j")
    assert again.run()[cell.cell_id].resumed and again.measure_calls == 0


def test_serving_grid_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tlaunch.run_grid("serving", device="cuda")


# ------------------------------------- optimizer throughput, campaign sweep, multi-instance
def test_optimizer_throughput_quick_passes_its_check(tmp_path):
    """The twin at quick size on the CPU: the reference's space, pool and
    sizes, a ``torch`` column beside ``numpy``, the engine's tell and refit
    times and its programs' counts; records under this process's ``cpu:``
    context."""
    with one_thread():
        recs = optimizer_throughput.bench(quick=True, device="cpu", out_dir=tmp_path)
    check.check_optimizer_throughput(expect_quick=True, bench_dir=tmp_path)
    d = json.loads((tmp_path / "optimizer_throughput.json").read_text())
    assert (d["d"], d["n_candidates"], d["device"]) == (6, 1280, "cpu")
    assert list(d["ask_latency_ms"]) == ["25"] and list(d["batched"]) == ["16"]
    e = d["engine"]["25"]
    assert (e["ask_bucket"], e["n_after"], e["bucket"]) == (32, 30, 32) and e["tell_ms"] > 0
    assert d["steps"]["gp.suggest"]["runs"] > 0 and d["steps"]["gp.suggest_batched"]["runs"] > 0
    assert [r.metric for r in recs] == ["ask_ms/numpy/n25", "ask_ms/torch/n25",
                                        "batched_ms/s8h16"]
    assert all(r.context.hardware.startswith("cpu:") for r in recs)
    bad = dict(d, batched={"16": dict(d["batched"]["16"], sessions=1)})
    (tmp_path / "optimizer_throughput.json").write_text(json.dumps(bad))
    with pytest.raises(AssertionError):
        check.check_optimizer_throughput(bench_dir=tmp_path)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_campaign_sweep_quick_warm_beats_cold(tmp_path, monkeypatch, backend):
    """The twin at quick size on the CPU with either BO backend: warm beats
    cold, every target cell promoted under this process's fingerprint, the
    optimizer defaults restored; the JSON passes the port's check and the
    reference's (``check_bench.check_campaign_sweep``)."""
    from repro_torch.core.optimizers import optimizer_defaults

    before = optimizer_defaults()
    with one_thread():
        res = campaign_sweep.run(quick=True, backend=backend, device="cpu", out_dir=tmp_path)
    assert optimizer_defaults() == before
    check.check_campaign_sweep(expect_quick=True, bench_dir=tmp_path)
    monkeypatch.setattr(jcheck_bench, "BENCH_DIR", tmp_path)     # the reference's own check
    jcheck_bench.check_campaign_sweep(expect_quick=True)
    assert list(res["cells"]) == ["torch_hashtable@s256", "torch_hashtable@s2048"]
    assert {row["promoted_under"] for row in res["cells"].values()} == {
        configstore.hardware_fingerprint()}
    assert (tmp_path / "campaign_sweep" / "store_warm").is_dir()


def test_multi_instance_quick_daemon_matches_the_baseline(tmp_path, monkeypatch):
    """The twin at quick size: one spawned daemon over four ``rs`` sessions
    reaches each in-process baseline's best; both checks pass."""
    recs = multi_instance.bench(quick=True, device="cpu", out_dir=tmp_path)
    check.check_multi_instance(expect_quick=True, bench_dir=tmp_path)
    monkeypatch.setattr(jcheck_bench, "BENCH_DIR", tmp_path)     # the reference's own check
    jcheck_bench.check_multi_instance(expect_quick=True)
    d = json.loads((tmp_path / "multi_instance.json").read_text())
    assert d["budget"] == 6 and d["optimizer"] == "rs"
    assert all(r["identical"] and r["evaluations"] == 6 for r in d["instances"].values())
    assert len(recs[0].values) == 2 and recs[0].context.workload == "hashtable_x4b6"


def test_the_engine_twins_refuse_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        optimizer_throughput.run(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        campaign_sweep.run(quick=True, backend="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        multi_instance.run_baseline(budget=2, optimizer="bo_torch")
    for fn in (optimizer_throughput.run, optimizer_throughput.bench, campaign_sweep.run,
               campaign_sweep.bench, multi_instance.run, multi_instance.bench):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ------------------------------------------------------------------ defaults
def test_no_default_path_is_shared_with_the_reference():
    """Online journal root and tuner id, trajectory, gate report, RPI root,
    tracking root and the twins' JSON: the port's defaults and the
    reference's (relative to the repository root, where its tools run) are
    all distinct."""
    def ref(p):
        return (ROOT / p).resolve()

    def default(fn, name):
        return inspect.signature(fn).parameters[name].default

    wl = "dense_c256"
    reference = {
        "online journal": ref(jonline.OnlineJournal(f"online-{wl}").path),
        "trajectory": ref(jbaseline.TRAJECTORY_PATH),
        "gate report": ref(Path(jcheck_bench.BENCH_DIR) / "gate_report.json"),
        "rpi": ref(default(jrpi.RPI.save, "root")),
        "runs": ref(default(jtracking.Tracker.__init__, "root")),
        "serve_scenarios.json": ref(Path(jcheck_bench.BENCH_DIR) / "serve_scenarios.json"),
        "online_tuning.json": ref(Path(jcheck_bench.BENCH_DIR) / "online_tuning.json"),
    }
    port_tuner_id = f"torch-online-{wl}"
    port = {
        "online journal": online.OnlineJournal(port_tuner_id).path.resolve(),
        "trajectory": Path(baseline.TRAJECTORY_PATH).resolve(),
        "gate report": (BENCH_ROOT / "gate_report.json").resolve(),
        "rpi": Path(rpi.RPI_ROOT).resolve(),
        "runs": Path(tracking.RUNS_ROOT).resolve(),
        "serve_scenarios.json": (BENCH_ROOT / "serve_scenarios.json").resolve(),
        "online_tuning.json": (BENCH_ROOT / "online_tuning.json").resolve(),
    }
    assert default(online.OnlineTuner.__init__, "journal_root") == online.ONLINE_ROOT
    assert default(runner.run_and_gate, "out_dir") == BENCH_ROOT
    assert default(runner.run_and_gate, "trajectory") == baseline.TRAJECTORY_PATH
    every = list(reference.values()) + list(port.values())
    assert len(set(every)) == len(every), {k: (reference[k], port[k]) for k in port}
    for p in port.values():
        assert ROOT / "results" / "torch" in p.parents
