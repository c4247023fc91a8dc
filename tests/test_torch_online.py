"""The port's online shadow/canary tuner (``repro_torch.runtime.online``).

Three parts:

  * the reference's ``tests/test_online.py`` contracts on the port's tuner,
    against a deterministic stand-in server whose per-window throughput is
    a planted function of the applied config (no model, no wall clock);
  * the tuner in the loop of the port's real server (reduced OLMo-1B, f32,
    CPU): every token stream stays bit-identical to the one-at-a-time gang
    and the host reads device values once per sync interval;
  * parity: the reference's and the port's tuners, fed the same scripted
    window metrics with the same seed and optimizer, journal the same
    canaries, verdicts, promotions and rollbacks, row by row.
"""
from __future__ import annotations

import json
import math
import zlib

import numpy as np
import pytest

from repro.core.configstore import ConfigStore as JConfigStore
from repro.runtime import online as jonline
from repro.runtime import serve_loop as jserve_loop
from repro_torch.configs import get_config
from repro_torch.core.configstore import ConfigStore, context_for
from repro_torch.core.registry import get_component
from repro_torch.models import model as M
from repro_torch.runtime import online, serve_loop
from repro_torch.runtime.online import (DEFAULT_ONLINE_KNOBS, ONLINE_SCHEMA_VERSION,
                                        OnlineJournal, OnlineTuner)
from repro_torch.runtime.serve_loop import HOT_SWAP_KNOBS, BatchedServer

import torch


class FakeServer:
    """Deterministic continuous-batching stand-in: one step = one window,
    whose tokens/s is a planted function of the live config times a seeded
    jitter."""

    mode = "continuous"
    workload = "fake-wl"

    def __init__(self, perf, seed: int = 0, jitter: float = 0.01, knobs=HOT_SWAP_KNOBS):
        self.perf = perf
        self.rng = np.random.default_rng(seed)
        self.jitter = jitter
        self.knobs = knobs
        self.cfg = {"max_batch": 8, "max_new_tokens": 32, "admission": 4,
                    "prefill_chunk": 64, "sync_interval": 4}
        self.decode_syncs = 0
        self.last_window = None
        self.queue = []
        self.live_slots = []
        self.applied = []

    def current_config(self):
        return dict(self.cfg)

    def apply_config(self, settings):
        bad = [k for k in settings if k not in self.knobs]
        if bad:
            raise ValueError(f"not hot-swappable: {bad}")
        self.cfg.update({k: int(v) for k, v in settings.items()})
        self.applied.append(dict(settings))

    def step(self):
        self.decode_syncs += 1
        v = self.perf(self.cfg) * float(1.0 + self.jitter * self.rng.standard_normal())
        self.last_window = {"tokens_per_s": v, "p50_latency_s": 0.01,
                            "queue_depth": 0.0, "live_slots": 1.0}
        return []


def _perf_flat(base=100.0):
    return lambda cfg: base


def _perf_sync8(cfg):
    return 200.0 if cfg["sync_interval"] == 8 else 100.0


@pytest.fixture
def store(tmp_path):
    return ConfigStore(tmp_path / "store")


def _tuner(tmp_path, store, server, **kw):
    kw.setdefault("optimizer", "rs")
    kw.setdefault("budget", 3)
    kw.setdefault("windows_per_eval", 6)
    kw.setdefault("seed", 5)
    return OnlineTuner(server, store=store, journal_root=tmp_path / "journal", **kw)


def _verdicts(tuner):
    return sum(1 for r in tuner.journal.rows() if r["kind"] == "canary_verdict")


def _run_one_canary(tuner, challenger, max_steps=64):
    """Plant ``challenger`` as the next proposal and step until its canary
    closes; returns the number of steps it took."""
    tuner._next_challenger = dict(challenger)
    before = _verdicts(tuner)
    for i in range(max_steps):
        tuner.step()
        if _verdicts(tuner) > before:
            return i + 1
    raise AssertionError("canary never closed")


# --------------------------------------------------- the reference's contracts
def test_planted_regression_rolls_back_within_one_window_pair(tmp_path, store):
    srv = FakeServer(lambda cfg: 40.0 if cfg["sync_interval"] >= 32 else 100.0)
    t = _tuner(tmp_path, store, srv)
    champion_before = dict(t.champion)
    assert _run_one_canary(t, {"sync_interval": 32}) <= 3
    assert t.rollbacks == 1 and t.promotions == 0
    assert t.champion == champion_before
    rows = t.journal.rows()
    assert [r["kind"] for r in rows][-2:] == ["canary_verdict", "rollback"]
    assert rows[-1]["reason"] == "regressed" and rows[-1]["restored"] == champion_before
    assert rows[-2]["verdict"]["verdict"] == "regressed"
    assert srv.applied[-1] == champion_before
    assert {k: srv.cfg[k] for k in champion_before} == champion_before


def test_challenger_only_ever_runs_on_its_b_windows(tmp_path, store):
    srv = FakeServer(_perf_flat())
    t = _tuner(tmp_path, store, srv)
    t._next_challenger = {"sync_interval": 9}
    for _ in range(2 * t.windows_per_eval + 2):
        t.step()
    seen = [a.get("sync_interval") for a in srv.applied if "sync_interval" in a]
    assert 9 in seen
    assert all(i == 0 or seen[i - 1] != 9 for i, v in enumerate(seen) if v == 9)


def test_improved_canary_promotes_with_live_baseline(tmp_path, store):
    srv = FakeServer(_perf_sync8)
    t = _tuner(tmp_path, store, srv)
    _run_one_canary(t, {"sync_interval": 8})
    assert t.promotions == 1 and t.rollbacks == 0 and t.champion["sync_interval"] == 8
    assert [r["kind"] for r in t.journal.rows()][-2:] == ["canary_verdict", "promote"]
    entry = store.resolve_entry(context_for("torch_serve_batching", "fake-wl"))
    assert entry["settings"]["sync_interval"] == 8
    prov = entry["provenance"]
    assert prov["source"] == "online" and prov["tuner"] == t.tuner_id
    assert prov["gate"]["verdict"] == "improved"
    assert srv.cfg["sync_interval"] == 8


def test_noise_canary_retains_champion(tmp_path, store):
    t = _tuner(tmp_path, store, FakeServer(_perf_flat()))
    champion_before = dict(t.champion)
    _run_one_canary(t, {"sync_interval": 8})
    assert t.promotions == 0 and t.rollbacks == 0 and t.champion == champion_before
    assert t.journal.rows()[-1]["kind"] == "canary_verdict"
    assert t.journal.rows()[-1]["verdict"]["verdict"] == "noise"
    assert store.resolve_entry(context_for("torch_serve_batching", "fake-wl")) is None


def test_budget_exhaustion_stops_canaries(tmp_path, store):
    t = _tuner(tmp_path, store, FakeServer(_perf_flat()), budget=2)
    for _ in range(100):
        t.step()
    assert sum(1 for r in t.journal.rows() if r["kind"] == "canary_start") == 2
    assert t._exhausted and t._canary is None


def test_window_pair_never_straddles_runs(tmp_path, store):
    srv = FakeServer(_perf_flat())
    t = _tuner(tmp_path, store, srv)
    t._next_challenger = {"sync_interval": 9}
    t.step()
    assert t._canary is not None and t._canary["phase"] == "B"
    srv.begin_run = lambda *a, **k: None
    t.begin_run()
    assert t._canary["phase"] == "A" and t._canary["ab"].pairs == 0


def test_journal_resume_reconstructs_champion_and_budget(tmp_path, store):
    t = _tuner(tmp_path, store, FakeServer(_perf_sync8), budget=5)
    _run_one_canary(t, {"sync_interval": 8})      # promote: new champion
    _run_one_canary(t, {"sync_interval": 32})     # regresses against it: rollback
    n_verdicts = _verdicts(t)
    srv2 = FakeServer(_perf_sync8)
    t2 = _tuner(tmp_path, store, srv2, budget=5, tuner_id=t.tuner_id)
    assert t2.champion == t.champion and t2.champion["sync_interval"] == 8
    assert t2._canary_seq == 2
    assert t2.core.session.budget == 5 - n_verdicts
    assert srv2.cfg["sync_interval"] == 8


def test_resume_rolls_back_orphaned_canary(tmp_path, store):
    t = _tuner(tmp_path, store, FakeServer(_perf_flat()))
    t._next_challenger = {"sync_interval": 9}
    t.step()
    assert [r["kind"] for r in t.journal.rows()] == ["canary_start"]
    t2 = _tuner(tmp_path, store, FakeServer(_perf_flat()), tuner_id=t.tuner_id)
    rows = t2.journal.rows()
    assert [r["kind"] for r in rows] == ["canary_start", "rollback"]
    assert rows[-1]["reason"] == "resume_orphaned_canary" and rows[-1]["seq"] == 1
    assert t2._canary is None


def test_future_schema_and_torn_rows_are_skipped(tmp_path, store):
    t = _tuner(tmp_path, store, FakeServer(_perf_flat()))
    t.journal.append("canary_start", seq=1, challenger={"sync_interval": 9},
                     champion=t.champion, windows=4)
    t.journal.append("canary_verdict", seq=1, challenger={"sync_interval": 9},
                     verdict={"verdict": "noise", "candidate_location": 100.0})
    with open(t.journal.path, "a") as f:
        f.write(json.dumps({"schema": ONLINE_SCHEMA_VERSION + 1,
                            "kind": "promote", "settings": {"sync_interval": 63}}) + "\n")
        f.write('{"truncated mid-wri')
    assert len(t.journal.rows()) == 2
    t2 = _tuner(tmp_path, store, FakeServer(_perf_flat()), tuner_id=t.tuner_id)
    assert t2.champion["sync_interval"] != 63 and t2._canary_seq == 1


def test_gang_server_is_rejected(tmp_path, store):
    srv = FakeServer(_perf_flat())
    srv.mode = "gang"
    with pytest.raises(ValueError, match="continuous"):
        _tuner(tmp_path, store, srv)


def test_non_hot_swappable_space_is_rejected(tmp_path, store):
    space = get_component("torch_serve_batching").space.subset(["max_batch"])
    with pytest.raises(ValueError, match="max_batch"):
        _tuner(tmp_path, store, FakeServer(_perf_flat()), space=space)


def test_default_space_and_ids_are_the_ports(tmp_path, store):
    t = _tuner(tmp_path, store, FakeServer(_perf_flat()))
    assert tuple(t.space.names) == DEFAULT_ONLINE_KNOBS
    assert set(t.space.names) <= set(HOT_SWAP_KNOBS)
    assert t.meta.name == online.COMPONENT == "torch_serve_batching"
    assert t.tuner_id == "torch-online-fake-wl"


def test_journal_is_append_only_schema_versioned(tmp_path):
    j = OnlineJournal("t1", root=tmp_path / "j")
    r1 = j.append("canary_start", seq=1)
    r2 = j.append("rollback", seq=1, reason="regressed")
    assert r1["schema"] == r2["schema"] == ONLINE_SCHEMA_VERSION
    lines = j.path.read_text().splitlines()
    assert len(lines) == 2 and all(json.loads(ln) for ln in lines)
    assert [r["kind"] for r in j.rows()] == ["canary_start", "rollback"]


# ------------------------------------------------- the tuner on the real server
CAPACITY = 32


@pytest.fixture(scope="module")
def served():
    cfg = get_config("olmo-1b").reduced().validate()
    return M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg


def _prompts(tag, n, lo=3, hi=14):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    return [rng.integers(2, 250, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


def _streams(server):
    return {r.rid: list(r.tokens) for r in server.results.values()}


@pytest.mark.parametrize("windows_per_eval", [1, 2])
def test_tuner_in_the_loop_keeps_streams_and_the_sync_bound(tmp_path, store, served,
                                                            monkeypatch, windows_per_eval):
    """Canaries hot-swap admission, prefill_chunk and sync_interval at every
    sync boundary; the streams still equal the one-at-a-time gang's, and
    ``_host_fetch`` runs once per sync, each fetch carrying exactly the
    decode steps of its interval."""
    params, cfg = served
    prompts = _prompts(("tuner", windows_per_eval), 8)
    gang = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode="gang",
                         settings={"max_batch": 1}, device="cpu")
    for p in prompts:
        gang.submit(p)
    gang.run(max_new_tokens=10)

    fetched = []
    real = serve_loop._host_fetch

    def counted(x):
        fetched.append(x.shape[0])
        return real(x)

    monkeypatch.setattr(serve_loop, "_host_fetch", counted)
    srv = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode="continuous",
                        settings={"max_batch": 3, "sync_interval": 2}, device="cpu")
    t = _tuner(tmp_path, store, srv, budget=4, windows_per_eval=windows_per_eval)
    for p in prompts:
        t.submit(p)
    m = t.run(max_new_tokens=10)
    assert _streams(srv) == _streams(gang)
    assert m["completed"] == 8
    assert len(fetched) == srv.decode_syncs == m["decode_syncs"]
    assert sum(fetched) == srv.decode_steps
    starts = [r for r in t.journal.rows() if r["kind"] == "canary_start"]
    assert starts, "no canary ran: the run never swapped a config"
    assert {k for r in starts for k in r["challenger"]} <= set(DEFAULT_ONLINE_KNOBS)


def test_tuner_and_server_both_refuse_max_batch(tmp_path, store, served):
    params, cfg = served
    srv = BatchedServer(params, cfg, capacity=CAPACITY, settings={"max_batch": 2}, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        srv.apply_config({"max_batch": 4})
    space = get_component("torch_serve_batching").space.subset(["max_batch", "sync_interval"])
    with pytest.raises(ValueError, match="max_batch"):
        _tuner(tmp_path, store, srv, space=space)


def test_tuner_resumes_on_a_fresh_server(tmp_path, store, served):
    """Kill and resume around a real server: the champion and the remaining
    budget come back from the journal, and the new server runs the champion."""
    params, cfg = served
    srv = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, settings={"max_batch": 2},
                        device="cpu")
    t = _tuner(tmp_path, store, srv, budget=3, windows_per_eval=1)
    t.champion = {**t.champion, "sync_interval": 3}   # as a promotion leaves it
    t.journal.append("promote", seq=0, settings=t.champion)
    for p in _prompts("resume", 6):
        t.submit(p)
    t.run(max_new_tokens=6)
    n = _verdicts(t)
    srv2 = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, settings={"max_batch": 2},
                         device="cpu")
    t2 = _tuner(tmp_path, store, srv2, budget=3, windows_per_eval=1, tuner_id=t.tuner_id)
    assert t2.champion == t.champion
    assert t2._exhausted == (n >= 3)
    if not t2._exhausted:
        assert t2.core.session.budget == 3 - n
    assert srv2.current_config()["sync_interval"] == t.champion["sync_interval"]


# ------------------------------------------------------ parity with the reference
def _scripted_perf(cfg):
    """Peaks at sync_interval 8 and admission 4: the random proposals land
    on both sides of the champion, so canaries promote, roll back and tie."""
    si = math.log2(cfg["sync_interval"]) - 3.0
    adm = math.log2(cfg["admission"]) - 2.0
    return 100.0 * math.exp(-si * si / 3.0) * math.exp(-adm * adm / 8.0)


def _strip(row):
    return {k: v for k, v in row.items() if k not in ("timestamp", "tuner")}


@pytest.mark.parametrize("seed,budget,windows", [(5, 6, 3), (11, 8, 4), (23, 6, 6)])
def test_journal_matches_the_reference_tuner(tmp_path, seed, budget, windows):
    """Same scripted windows, same seed, optimizer ``rs``: both tuners take
    the same decisions.  The window jitter comes from one crc32-seeded numpy
    stream per package; each tuner's journal, champion, promotions and
    rollbacks must agree row by row (timestamps and ids excluded)."""
    jitter_seed = zlib.crc32(repr(("parity", seed)).encode())
    runs = {}
    for name, tuner_cls, store_cls, knobs in (
            ("ref", jonline.OnlineTuner, lambda p: JConfigStore(root=str(p)),
             jserve_loop.HOT_SWAP_KNOBS),
            ("port", OnlineTuner, ConfigStore, HOT_SWAP_KNOBS)):
        srv = FakeServer(_scripted_perf, seed=jitter_seed, jitter=0.03, knobs=knobs)
        t = tuner_cls(srv, store=store_cls(tmp_path / name / "store"),
                      journal_root=str(tmp_path / name / "journal"), tuner_id="parity",
                      optimizer="rs", budget=budget, windows_per_eval=windows, seed=seed)
        for _ in range(400):
            if t._exhausted and t._canary is None:
                break
            t.step()
        runs[name] = (t, [_strip(r) for r in t.journal.rows()], srv.applied)
    (jt, jrows, japplied), (pt, prows, papplied) = runs["ref"], runs["port"]
    assert len(prows) == len(jrows) and prows == jrows
    assert {r["kind"] for r in prows} >= {"canary_start", "canary_verdict"}
    assert pt.champion == jt.champion
    assert (pt.promotions, pt.rollbacks) == (jt.promotions, jt.rollbacks)
    assert papplied == japplied
