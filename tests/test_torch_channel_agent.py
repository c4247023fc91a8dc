"""The port's shared-memory channel, telemetry and agent daemon
(``repro_torch.core`` channel, telemetry and agent), on the CPU.

The channel tests are copies of the reference's tests/test_core_channel.py
over the port's ring.  Then: the port's ring names (never a reference
``psm_*`` name), the OS counters and the emitter, the spawned
``AgentProcess`` end to end (the reference's
test_core_agent.py::test_agent_process_end_to_end, over the port's
spinlock), the agent tuning ``torch_train_loop.lr_scale`` of a live
``run_training`` over the channel, the server's emitter, and the gates the
slice adds: ``promote_session_report``'s ``rpi=``/``run=`` and
``Campaign``'s ``rpi_lookup``, each against the reference's behavior.

``hypothesis`` is optional: the property test runs when it is installed; a
deterministic pseudo-random sweep of the same invariant always runs.
"""
import json
import multiprocessing
import os
import struct

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # pragma: no cover - exercised in hypothesis-less CI
    given = None

from repro_torch.core.channel import MlosChannel, ShmRing


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


@pytest.fixture
def ring():
    r = ShmRing(capacity=1 << 12)
    yield r
    r.close()
    r.unlink()


def test_push_pop_fifo(ring):
    msgs = [f"msg-{i}".encode() for i in range(10)]
    for m in msgs:
        assert ring.push(m)
    assert ring.drain() == msgs
    assert ring.pop() is None


def test_wraparound(ring):
    # Force many wraps with messages that don't divide capacity.
    for i in range(2000):
        m = bytes([i % 256]) * (17 + i % 61)
        assert ring.push(m), f"push failed at {i}"
        got = ring.pop()
        assert got == m


def test_full_ring_drops_not_blocks(ring):
    m = b"x" * 100
    pushed = 0
    while ring.push(m):
        pushed += 1
        assert pushed < 100  # must fill eventually
    assert pushed >= (1 << 12) // 110
    # After draining one, pushes succeed again.
    assert ring.pop() == m
    assert ring.push(m)


def test_payload_too_large(ring):
    with pytest.raises(ValueError):
        ring.push(b"y" * (1 << 12))


def _fifo_roundtrip(payloads):
    r = ShmRing(capacity=1 << 14)
    try:
        kept = []
        for p in payloads:
            if r.push(p):
                kept.append(p)
        assert r.drain() == kept
    finally:
        r.close()
        r.unlink()


if given is not None:

    @given(st.lists(st.binary(min_size=1, max_size=200), min_size=1, max_size=60))
    @settings(max_examples=50, deadline=None)
    def test_property_fifo_roundtrip(payloads):
        _fifo_roundtrip(payloads)


def test_fifo_roundtrip_deterministic():
    """Non-hypothesis sweep of the same invariant (fixed-seed fuzz)."""
    rng = np.random.default_rng(42)
    for _ in range(25):
        payloads = [rng.bytes(int(rng.integers(1, 201)))
                    for _ in range(int(rng.integers(1, 61)))]
        _fifo_roundtrip(payloads)


# -------------------------------------------------------------- push_many
def test_push_many_fifo_and_mixing(ring):
    msgs = [f"batch-{i}".encode() for i in range(8)]
    assert ring.push_many(msgs) == 8
    assert ring.push(b"single")  # batched and single producers interleave
    assert ring.push_many([b"tail-a", b"tail-b"]) == 2
    assert ring.drain() == msgs + [b"single", b"tail-a", b"tail-b"]


def test_push_many_wrap_straddling_batch():
    """A batch whose records straddle the end-of-buffer wrap: the producer
    must emit the wrap marker mid-batch and still publish the head once."""
    r = ShmRing(capacity=1 << 8)
    try:
        # Park the cursor near the end: 3×58-byte records (62 w/ header)
        # put the write cursor at 186 of 256; drain frees the space.
        first = [bytes([i]) * 58 for i in range(3)]
        assert r.push_many(first) == 3
        assert r.drain() == first
        # 40-byte records: the second one needs the wrap marker (186+44=230,
        # +44 > 256) — the batch straddles the boundary.
        batch = [bytes([0x40 + i]) * 40 for i in range(4)]
        assert r.push_many(batch) == 4
        assert r.head // r.capacity > 0  # wrapped inside the batch
        assert r.drain() == batch
        assert r.pop() is None
    finally:
        r.close()
        r.unlink()


def test_push_many_partial_on_full(ring):
    msgs = [bytes([i]) * 100 for i in range(80)]  # way beyond capacity
    sent = ring.push_many(msgs)
    assert 0 < sent < len(msgs)
    assert ring.drain() == msgs[:sent]  # the accepted prefix, in order
    assert ring.push_many(msgs[sent:sent + 2]) == 2  # space freed → resumes


def test_push_many_oversize_rejected_before_publish(ring):
    head_before = ring.head
    with pytest.raises(ValueError):
        ring.push_many([b"ok", b"y" * (1 << 12)])
    assert ring.head == head_before  # nothing published
    assert ring.pop() is None


def _producer(name: str, n: int) -> None:
    r = ShmRing(name, create=False)
    sent = 0
    while sent < n:
        if r.push(struct.pack("<I", sent) + os.urandom(16)):
            sent += 1
    r.close()


def test_cross_process_spsc():
    r = ShmRing(capacity=1 << 14)
    try:
        n = 500
        # spawn, not fork: the pytest process holds threads (and, on the card, CUDA)
        p = multiprocessing.get_context("spawn").Process(
            target=_producer, args=(r.name, n), daemon=True)
        p.start()
        seen = 0
        while seen < n:
            payload = r.pop()
            if payload is None:
                continue
            (i,) = struct.unpack_from("<I", payload, 0)
            assert i == seen  # strict FIFO across processes
            seen += 1
        p.join(5)
        assert not p.is_alive()
    finally:
        r.close()
        r.unlink()


def test_duplex_channel():
    ch = MlosChannel.create(capacity=1 << 12)
    try:
        ch.telemetry.push(b"tele")
        ch.control.push(b"ctrl")
        assert ch.telemetry.pop() == b"tele"
        assert ch.control.pop() == b"ctrl"
    finally:
        ch.close()


# ------------------------------------------------------------ the port's own
def test_ring_names_never_collide_with_a_reference_channel():
    from repro.core.channel import ShmRing as JRing

    mine, theirs = ShmRing(capacity=1 << 10), JRing(capacity=1 << 10)
    try:
        assert mine.name.startswith(f"rt_{os.getpid()}_") and not theirs.name.startswith("rt_")
        mine.push(b"port")
        theirs.push(b"reference")
        assert mine.pop() == b"port" and theirs.pop() == b"reference"
    finally:
        for r in (mine, theirs):
            r.close()
            r.unlink()


def test_os_counters_persistent_handles():
    """Repeated samples reuse the cached /proc file objects (seek(0) + read,
    no reopen) and stay monotone where the kernel guarantees it."""
    from repro_torch.core import telemetry

    a = telemetry.os_counters()
    reader = telemetry._PROC_READERS["self"]
    sum(i * i for i in range(20000))
    b = telemetry.os_counters()
    assert telemetry._PROC_READERS["self"] is reader
    assert {"utime_s", "stime_s", "rss_bytes", "vctx", "nvctx", "minflt"} <= set(b)
    assert b["utime_s"] + b["stime_s"] >= a["utime_s"] + a["stime_s"]
    assert b["rss_bytes"] > 0
    assert set(telemetry.compile_cache_counters()) >= {"hits", "misses", "entries"}


def test_emitter_packs_and_drops_instead_of_blocking():
    from repro_torch.core.codegen import unpack_telemetry
    from repro_torch.core.registry import get_component
    from repro_torch.core.telemetry import Stopwatch, TelemetryEmitter
    from repro_torch.runtime import train_loop  # noqa: F401 — registers torch_train_loop

    meta = get_component("torch_train_loop")
    chan = MlosChannel.create(capacity=1 << 8)
    try:
        em = TelemetryEmitter(meta, chan, instance_id=3)
        with Stopwatch() as sw:
            sent = em.emit_many([{"loss": float(i), "step_time_s": 0.5, "extra": 1}
                                 for i in range(20)])
        assert sw.elapsed_s >= 0 and 0 < sent < 20 and em.dropped == 20 - sent
        assert not em.emit({"loss": 9.0, "step_time_s": 1.0}) and em.dropped == 21 - sent
        rows = [unpack_telemetry(meta, p) for p in chan.telemetry.drain()]
        assert [r["loss"] for r in rows] == [float(i) for i in range(sent)]
        assert {r["instance_id"] for r in rows} == {3}
    finally:
        chan.close()


def test_server_emits_onto_the_channel():
    """The server's ``emitter=`` takes the port's TelemetryEmitter: each sync
    window and the run's totals reach the ring as packed records."""
    from repro_torch.configs import get_config
    from repro_torch.core.codegen import unpack_telemetry
    from repro_torch.core.registry import get_component
    from repro_torch.core.telemetry import TelemetryEmitter
    from repro_torch.models import model as M
    from repro_torch.runtime.serve_loop import BatchedServer

    cfg = get_config("olmo-1b").reduced().validate()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    meta = get_component("torch_serve_batching")
    chan = MlosChannel.create(capacity=1 << 14)
    try:
        srv = BatchedServer(params, cfg, capacity=32, device="cpu",
                            emitter=TelemetryEmitter(meta, chan))
        for i in range(3):
            srv.submit(np.arange(2, 6 + i, dtype=np.int32))
        m = srv.run(max_new_tokens=4)
        rows = [unpack_telemetry(meta, p) for p in chan.telemetry.drain()]
        assert len(rows) >= 2 and rows[-1]["tokens_per_s"] == pytest.approx(m["tokens_per_s"])
    finally:
        chan.close()


# ------------------------------------------------------------ the daemon
@pytest.mark.slow
def test_agent_process_end_to_end():
    """Full production shape: agent in a separate process over shm channel."""
    from conftest import wait_until
    from repro_torch.core.agent import AgentClient, AgentProcess, make_session
    from repro_torch.core.registry import get_component
    from repro_torch.core.smartcomponents import SpinLock, spinlock_workload
    from repro_torch.core.telemetry import TelemetryEmitter

    meta = get_component("torch_spinlock")
    session = make_session(meta, "throughput_ops_s", mode="max", optimizer="rs", budget=8,
                           seed=2)
    chan = MlosChannel.create(capacity=1 << 16)
    try:
        agent = AgentProcess(chan, session).start()
        client = AgentClient(chan)
        lock = SpinLock()
        client.register("torch_spinlock", lock)
        emitter = TelemetryEmitter(meta, chan)
        evals = 0
        while evals < 8:
            applied = client.poll(wait_s=0.002, deadline_s=20.0)
            if applied == 0 and not client.reports:
                continue
            emitter.emit(spinlock_workload(lock, heavy_ops=8, seed=3))
            evals += 1
        assert wait_until(lambda: client.reports,
                          tick=lambda: client.poll(wait_s=0.002, deadline_s=0.01))
        agent.stop()
        assert not agent.proc.is_alive()
        rep = client.reports[0]
        assert rep["evaluations"] == 8
        assert rep["best_value"] < 0  # maximization stored negated
    finally:
        chan.close()


def test_agent_process_snapshots_optimizer_defaults():
    """The host's optimizer defaults travel into the spawned daemon, and its
    target and arguments pickle (a spawn child receives them that way)."""
    import pickle

    from repro_torch.core.agent import AgentProcess, agent_main, make_session
    from repro_torch.core.optimizers import optimizer_defaults

    session = make_session("torch_spinlock", "throughput_ops_s", mode="max", budget=2)
    chan = MlosChannel.create(capacity=1 << 12)
    try:
        agent = AgentProcess(chan, session)     # not started: the snapshot only
        assert agent.proc._target is agent_main
        assert json.loads(agent.proc._kwargs["optimizer_defaults_json"]) == optimizer_defaults()
        pickle.dumps((agent.proc._target, agent.proc._args, agent.proc._kwargs))
        assert agent.proc._popen is None and type(agent.proc).__name__ == "SpawnProcess"
    finally:
        chan.close()


@pytest.mark.slow
def test_agent_tunes_the_train_loop_lr_scale():
    """Figure 1 on the CPU: a spawned agent runs a ``torch_train_loop``
    session over ``lr_scale`` (bo, budget 4, 2 steps a config) against a
    live ``run_training``; every config lands through ``AgentClient`` and
    ``lr_scale_source``, the session report arrives and the daemon exits."""
    from repro_torch.configs import get_config
    from repro_torch.core.agent import AgentClient, AgentProcess, TrackedInstance, make_session
    from repro_torch.runtime.train_loop import run_training, train_settings, workload_signature

    budget, per = 4, 2
    cfg = get_config("olmo-1b").reduced().validate()
    session = make_session("torch_train_loop", "loss", optimizer="bo", budget=budget,
                           samples_per_config=per, seed=0,
                           workload=workload_signature(2, 32, cfg.d_model))
    chan = MlosChannel.create(capacity=1 << 16)
    applied, seen = [], []

    class Dial:
        lr_scale = None

        def apply_settings(self, s):
            self.lr_scale = float(s["lr_scale"])
            applied.append(self.lr_scale)

    dial = Dial()
    try:
        agent = AgentProcess(chan, session).start()
        client = AgentClient(chan)
        client.register("torch_train_loop", TrackedInstance(dial))
        assert client.poll(wait_s=0.002, deadline_s=60.0) == 1      # the first proposal

        def on_step(step, metrics):
            seen.append(dial.lr_scale)
            if (step + 1) % per == 0 and len(applied) <= budget:
                assert client.poll(wait_s=0.002, deadline_s=60.0) >= 1, step

        out = run_training(cfg, n_steps=budget * per + 2, global_batch=2, seq_len=32,
                           channel=chan, on_step=on_step,
                           lr_scale_source=lambda: dial.lr_scale, seed=0, device="cpu")
        agent.proc.join(30)
        client.poll()
        assert not agent.proc.is_alive() and agent.proc.exitcode == 0
    finally:
        chan.close()
    assert len(applied) == budget + 1                    # 4 proposals, then the best
    assert seen == [a for a in applied[:budget] for _ in range(per)] + [applied[-1]] * 2
    rep = client.report_for("torch_train_loop")
    assert rep is not None and rep["evaluations"] == budget
    assert rep["best_config"]["lr_scale"] == applied[-1]
    assert all(train_settings.mlos_meta.space["lr_scale"].low <= a <= 16.0 for a in applied)
    assert len(out["history"]) == budget * per + 2


# ------------------------------------------------------------ the gates
def _report(context, best, mode="min", objective="time_us"):
    return {"type": "session_report", "component": context["component"], "instance": 0,
            "best_config": {"impl": "naive", "block_q": 64, "block_kv": 64},
            "best_value": best if mode == "min" else -best, "evaluations": 5,
            "objective": objective, "mode": mode, "budget": 5, "context": context}


@pytest.mark.parametrize("high,extra_bound,accepted", [(10.0, False, False), (100.0, False, True),
                                                       (100.0, True, True)])
def test_promote_session_report_rpi_and_run_match_reference(tmp_path, high, extra_bound,
                                                            accepted):
    """The reference's test_promote_session_report_roundtrip, both packages:
    an objective bound rejects (42 > 10) or admits, a bound on a metric the
    report cannot carry never vetoes, and the tracked run records the
    verdict, the objective and (promoted) the config."""
    from repro.core import Tracker as JTracker
    from repro.core import configstore as jstore
    from repro.core import promote_session_report as jpromote
    from repro.core.rpi import RPI as JRPI
    from repro.core.rpi import Bound as JBound
    from repro_torch.core import configstore as tstore
    from repro_torch.core.agent import promote_session_report
    from repro_torch.core.rpi import RPI, Bound
    from repro_torch.core.tracking import Tracker

    out = {}
    for pkg, store_mod, rpi_cls, bound, tracker, promote in (
            ("j", jstore, JRPI, JBound, JTracker, jpromote),
            ("t", tstore, RPI, Bound, Tracker, promote_session_report)):
        ctx = {"component": "flash_attention", "workload": "b2q512k512d64",
               "hardware": "hw0", "sw": "sw0"}
        bounds = (bound("time_us", high=high),) + ((bound("hlo_bytes", high=1e9),)
                                                    if extra_bound else ())
        store = store_mod.ConfigStore(str(tmp_path / pkg / "store"))
        with tracker(root=str(tmp_path / pkg / "runs")).start_run("tune") as run:
            ok = promote(store, _report(ctx, 42.0), rpi=rpi_cls("flash_attention",
                                                                "b2q512k512d64", bounds),
                         run=run)
        entry = store.resolve_entry(store_mod.Context.from_dict(ctx))
        out[pkg] = (ok, entry and entry["settings"],
                    entry and entry["provenance"]["run_id"] == run.run_id,
                    dict(run.tags), dict(run.params))
    assert out["t"] == out["j"] and out["t"][0] is accepted


def test_agent_client_promotes_arriving_reports_through_rpi_lookup(tmp_path):
    """A report pushed onto the control ring is promoted into the client's
    store as it arrives, gated by ``rpi_lookup`` per context."""
    from repro_torch.core.agent import AgentClient
    from repro_torch.core.configstore import ConfigStore, Context
    from repro_torch.core.rpi import RPI, Bound

    store = ConfigStore(str(tmp_path / "store"))
    lookups = []

    def rpi_lookup(component, workload):
        lookups.append((component, workload))
        return RPI(component, workload, (Bound("time_us", high=50.0),))

    chan = MlosChannel.create(capacity=1 << 14)
    try:
        client = AgentClient(chan, store=store, rpi_lookup=rpi_lookup)
        ctx = {"component": "torch_flash_attention", "hardware": "hw0", "sw": "sw0"}
        for wl, best in (("b1q128k128d128", 42.0), ("b2q256k256d128", 80.0)):
            chan.control.push(json.dumps(_report({**ctx, "workload": wl}, best)).encode())
        assert client.poll() == 0                      # reports apply no config
    finally:
        chan.close()
    assert [ok for _, ok in client.promotions] == [True, False]
    assert lookups == [("torch_flash_attention", "b1q128k128d128"),
                       ("torch_flash_attention", "b2q256k256d128")]
    assert store.resolve(Context.from_dict({**ctx, "workload": "b1q128k128d128"})) is not None
    assert store.resolve(Context.from_dict({**ctx, "workload": "b2q256k256d128"})) is None


def test_campaign_rpi_lookup_matches_reference(tmp_path):
    """Both packages' Campaign over two demo cells with an envelope that one
    cell's best violates: the same cells promoted, the same rejected."""
    from repro.core import campaign as jcampaign
    from repro.core import configstore as jstore
    from repro.core import smartcomponents as _jsmart  # noqa: F401 — registers the demo
    from repro.core.rpi import RPI as JRPI
    from repro.core.rpi import Bound as JBound
    from repro_torch.core import campaign as tcampaign
    from repro_torch.core import configstore as tstore
    from repro_torch.core import smartcomponents as _tsmart  # noqa: F401
    from repro_torch.core.rpi import RPI, Bound

    def measure(cell, settings):
        d2 = sum((float(v) - 3.0) ** 2 for v in settings.values()
                 if isinstance(v, (int, float)) and not isinstance(v, bool))
        v = 1000.0 * d2 + 5.0
        return {"time_us": v, "collisions": int(v), "memory_bytes": 0, "load_factor_ppm": 0}

    out = {}
    for pkg, camp, store_mod, rpi_cls, bound, name in (
            ("j", jcampaign, jstore, JRPI, JBound, "hashtable"),
            ("t", tcampaign, tstore, RPI, Bound, "torch_hashtable")):
        cells = [camp.CampaignCell(name, wl, "collisions", mode="min", budget=4, seed=i)
                 for i, wl in enumerate(("n1024l2", "n2048l2"))]
        lookup = lambda comp, wl, rc=rpi_cls, b=bound: rc(
            comp, wl, (b("collisions", high=0.0 if wl == "n2048l2" else 1e12),))
        c = camp.Campaign(cells, measure, campaign_id="rpi", store=store_mod.ConfigStore(
            str(tmp_path / pkg / "store")), journal_root=str(tmp_path / pkg / "j"),
            rpi_lookup=lookup)
        out[pkg] = {cid.split("@")[1]: (r.promoted, r.best_config, r.best_value)
                    for cid, r in c.run().items()}
    assert out["t"] == out["j"]
    assert out["t"]["n1024l2"][0] and not out["t"]["n2048l2"][0]
