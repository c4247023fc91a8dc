"""The port's RPI envelopes, run tracking and benchmark trajectory
(``repro_torch.core.{rpi,tracking,baseline}``) against the reference's on
the same samples, drawn with numpy from crc32 seeds; and the RPI arm of the
port's ``ConfigStore.promote``.
"""
from __future__ import annotations

import json
import subprocess
import zlib

import numpy as np
import pytest

from repro.core import baseline as jbaseline
from repro.core import configstore as jstore
from repro.core import rpi as jrpi
from repro.core import tracking as jtracking
from repro_torch.core import baseline, configstore, rpi, tracking
from repro_torch.core.baseline import SCHEMA_VERSION, BaselineStore, BenchRecord
from repro_torch.core.configstore import ConfigStore, Context


def _samples(tag, n=20, loc=100.0, scale=3.0):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    return rng.normal(loc, scale, n).tolist()


def _bounds(r):
    return [(b.metric, b.low, b.high) for b in r.bounds]


# ------------------------------------------------------------------- RPI
@pytest.mark.parametrize("slack,q_low,q_high", [(0.25, 0.05, 0.95), (0.1, 0.25, 0.75),
                                                (0.0, 0.0, 1.0)])
def test_from_samples_envelopes_equal_the_references(slack, q_low, q_high):
    samples = {"lat_ms": _samples("lat") + [1000.0], "tok_s": _samples("tok", loc=2000.0),
               "empty": []}
    got = rpi.RPI.from_samples("c", "w", samples, slack=slack, q_low=q_low, q_high=q_high)
    want = jrpi.RPI.from_samples("c", "w", samples, slack=slack, q_low=q_low, q_high=q_high)
    assert _bounds(got) == _bounds(want) and len(got.bounds) == 2


def test_learned_envelopes_equal_the_references(tmp_path):
    trackers = (tracking.Tracker(root=tmp_path / "t"), jtracking.Tracker(root=str(tmp_path / "j")))
    for i in range(4):
        vals = _samples(("run", i), n=5, loc=10.0 + i)
        for tr in trackers:
            with tr.start_run("bench", f"r{i}") as run:
                for step, v in enumerate(vals):
                    run.log_metric("time_us", v, step)
                run.log_params({"i": i})
    got = rpi.RPI.learn("c", "w", trackers[0], "bench", ["time_us"])
    want = jrpi.RPI.learn("c", "w", trackers[1], "bench", ["time_us"])
    assert _bounds(got) == _bounds(want)
    for v in (8.0, 11.0, 14.5, 25.0):
        assert bool(got.check({"time_us": v})) == bool(want.check({"time_us": v}))
    best = trackers[0].best_run("bench", "time_us")
    assert best.run_id == jtracking.Tracker(root=str(tmp_path / "j")).best_run(
        "bench", "time_us").run_id
    assert best.params == {"i": int(best.run_id[1:])}
    assert best.meta["status"] == "FINISHED"


def test_rpi_check_save_load_and_assert(tmp_path):
    r = rpi.RPI("comp", "wl", (rpi.Bound("x", low=0.0, high=2.0), rpi.Bound("y", high=1.0)))
    assert r.check({"x": 1.0, "y": 0.5}).checked == 2
    bad = r.check({"x": 3.0})
    assert not bad and any("missing" in v for v in bad.violations)
    with pytest.raises(AssertionError):
        rpi.assert_rpi(r, {"x": 3.0, "y": 0.5})
    r.save(root=tmp_path)
    back = rpi.RPI.load("comp", "wl", root=tmp_path)
    assert _bounds(back) == _bounds(r)


def test_a_crashing_run_is_marked_failed(tmp_path):
    tr = tracking.Tracker(root=tmp_path)
    with pytest.raises(RuntimeError):
        with tr.start_run("e", "r0") as run:
            run.log_metric("m", 1.0)
            raise RuntimeError("boom")
    (rec,) = list(tr.runs("e"))
    assert rec.meta["status"] == "FAILED" and "boom" in rec.meta["error"]
    assert rec.last("m") == 1.0


# --------------------------------------------------------------- promote
def test_promote_with_a_violated_rpi_is_rejected_and_leaves_the_store(tmp_path):
    store = ConfigStore(tmp_path / "cs")
    ctx = Context("comp", "wl0", "cpu:x86_64:x1", "sw0")
    envelope = rpi.RPI("comp", "wl0", (rpi.Bound("lat_ms", high=120.0),))
    assert store.put(ctx, {"k": 1})
    before = (tmp_path / "cs" / "comp.json").read_text()
    assert not store.promote(ctx, {"k": 2}, rpi=envelope, metrics={"lat_ms": 150.0})
    assert not store.promote(ctx, {"k": 2}, rpi=envelope, metrics={})        # missing
    assert (tmp_path / "cs" / "comp.json").read_text() == before
    assert store.resolve(ctx) == {"k": 1}
    assert store.promote(ctx, {"k": 3}, rpi=envelope, metrics={"lat_ms": 100.0})
    assert store.resolve(ctx) == {"k": 3}


@pytest.mark.parametrize("lat", [90.0, 119.9, 120.1, 500.0])
def test_promote_rpi_verdicts_equal_the_references(tmp_path, lat):
    envelope = {"t": rpi.RPI("c", "w", (rpi.Bound("lat_ms", low=10.0, high=120.0),)),
                "j": jrpi.RPI("c", "w", (jrpi.Bound("lat_ms", low=10.0, high=120.0),))}
    got = ConfigStore(tmp_path / "t").promote(Context("c", "w", "h", "s"), {"k": 1},
                                              rpi=envelope["t"], metrics={"lat_ms": lat})
    want = jstore.ConfigStore(str(tmp_path / "j")).promote(
        jstore.Context("c", "w", "h", "s"), {"k": 1}, rpi=envelope["j"], metrics={"lat_ms": lat})
    assert got == want == (lat <= 120.0)


# ------------------------------------------------------------- trajectory
def _rec(values, metric="lat_ms", workload="wl0", pkg=baseline):
    return pkg.BenchRecord.for_component("synthetic", metric, values, "comp", workload)


@pytest.fixture
def traj(tmp_path):
    return BaselineStore(tmp_path / "trajectory.jsonl")


def test_append_roundtrips_with_the_ports_context(traj):
    traj.append([_rec([1.0, 2.0, 3.0])], quick=True, sha="abc123", timestamp=42.0, run_id="r1")
    (row,) = list(traj.rows())
    assert row["schema"] == SCHEMA_VERSION and row["values"] == [1.0, 2.0, 3.0]
    assert row["git_sha"] == "abc123" and row["quick"] is True and row["run_id"] == "r1"
    assert row["context"]["hardware"] == configstore.hardware_fingerprint()
    assert row["context"]["sw"].startswith("torch-")


def test_the_trajectory_is_append_only(traj):
    for i in range(3):
        traj.append([_rec([float(i)])], timestamp=float(i))
    first = traj.path.read_text()
    traj.append([_rec([9.0])], timestamp=9.0)
    assert traj.path.read_text().startswith(first)
    assert [r["values"] for r in traj.rows()] == [[0.0], [1.0], [2.0], [9.0]]


def test_torn_and_future_schema_lines_are_skipped(traj):
    traj.append([_rec([1.0])])
    with open(traj.path, "a") as f:
        f.write("{torn json\n")
        f.write(json.dumps({"schema": SCHEMA_VERSION + 1, "benchmark": "synthetic"}) + "\n")
    traj.append([_rec([2.0])])
    assert [r["values"] for r in traj.rows()] == [[1.0], [2.0]]


def test_a_card_record_never_gates_a_cpu_one(traj):
    card = BenchRecord("synthetic", "lat_ms", _samples("card"),
                       Context("comp", "wl0", "cuda:NVIDIA_H100_80GB_HBM3:x1",
                               configstore.sw_fingerprint()))
    traj.append([card], quick=True)
    rep = traj.check(_rec(_samples("cpu", loc=300.0)), quick=True)
    assert rep.verdict == "no_baseline" and rep.ok


@pytest.mark.parametrize("history,current", [
    ([("h", 0)], ("c", 100.0)),
    ([("h", 0), ("h", 1), ("h", 2)], ("c", 100.0)),
    ([("h", 0), ("h", 1), ("h", 2)], ("c", 200.0)),
    ([("h", 0), ("h", 1)], ("c", 50.0)),
    ([("h", 0)], ("c", 130.0)),
], ids=["noise1", "noise3", "regressed", "improved", "shift30"])
def test_gate_verdicts_equal_the_references(tmp_path, history, current):
    stores = {"t": BaselineStore(tmp_path / "t.jsonl"),
              "j": jbaseline.BaselineStore(str(tmp_path / "j.jsonl"))}
    for i, tag in enumerate(history):
        vals = _samples(tag)
        stores["t"].append([_rec(vals)], quick=True, timestamp=float(i), sha="s")
        stores["j"].append([_rec(vals, pkg=jbaseline)], quick=True, timestamp=float(i), sha="s")
    cur = _samples(current[0], loc=current[1])
    got = stores["t"].check(_rec(cur), quick=True)
    want = stores["j"].check(_rec(cur, pkg=jbaseline), quick=True)
    assert (got.verdict, got.baseline_runs, got.baseline_n) == \
        (want.verdict, want.baseline_runs, want.baseline_n)
    assert got.comparison.to_dict() == want.comparison.to_dict()


def test_singleton_shifts_read_insufficient_data(traj):
    traj.append([_rec([100.0])], quick=True, timestamp=1.0)
    for v in (150.0, 50.0):
        rep = traj.check(_rec([v]), quick=True)
        assert rep.verdict == "insufficient_data" and rep.ok and rep.comparison.p_value is None


def test_rpi_from_the_baseline_store_equals_the_references(tmp_path):
    t, j = BaselineStore(tmp_path / "t.jsonl"), jbaseline.BaselineStore(str(tmp_path / "j.jsonl"))
    vals = _samples("base", n=40)
    t.append([_rec(vals)], quick=True)
    j.append([_rec(vals, pkg=jbaseline)], quick=True)
    got = rpi.RPI.from_baseline("comp", "wl0", t, [_rec([0.0])])
    want = jrpi.RPI.from_baseline("comp", "wl0", j, [_rec([0.0], pkg=jbaseline)])
    assert _bounds(got) == _bounds(want)


def test_a_missing_git_sha_does_not_fail_a_run(tmp_path, monkeypatch):
    """A run from a ``git archive`` has no commit of its own, even unpacked
    inside a checkout: its sha is None, never the enclosing tree's, and the
    process's working directory plays no part."""
    assert baseline.git_sha(tmp_path) is None                 # no checkout at all
    git = ["git", "-c", "user.name=t", "-c", "user.email=t@t", "-c", "commit.gpgsign=false"]
    checkout = tmp_path / "checkout"
    archive = checkout / "build" / "archive"
    archive.mkdir(parents=True)
    subprocess.run([*git, "init", "-q", str(checkout)], check=True)
    subprocess.run([*git, "-C", str(checkout), "commit", "-q", "--allow-empty", "-m", "c"],
                   check=True)
    sha = subprocess.run(["git", "-C", str(checkout), "rev-parse", "HEAD"], check=True,
                         capture_output=True, text=True).stdout.strip()
    assert baseline.git_sha(checkout) == sha
    assert baseline.git_sha(archive) is None
    monkeypatch.setattr(baseline, "REPO_ROOT", archive)       # the package in the archive
    monkeypatch.chdir(checkout)
    (row,) = BaselineStore(tmp_path / "x.jsonl").append([_rec([1.0])])
    assert row["git_sha"] is None
