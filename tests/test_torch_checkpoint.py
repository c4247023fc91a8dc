"""The port's training runtime (``repro_torch.runtime`` checkpoint, fault,
chaos and train loop, ``repro_torch.data.pipeline``): copies of the
reference's tests/test_runtime.py (checkpoint, fault, data and train-loop
tests) and tests/test_chaos.py over the port's modules, on the CPU, plus
the port's own: the checkpoint's on-disk layout (bf16 as uint16 bits),
restore onto the template's device and dtype, the host snapshot taken
inside ``save``, and the pipeline's parity with the reference's tokens.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import PackedBatcher, PrefetchingBatcher, SyntheticCorpus
from repro_torch.runtime.chaos import (
    SCENARIOS,
    ChaosInjector,
    Fault,
    corrupt_checkpoint,
    kills,
    mixed,
    plan_from_json,
    plan_to_json,
    respawn,
)
from repro_torch.runtime.checkpoint import (AsyncCheckpointer, latest_step,
                                            restore_checkpoint, save_checkpoint,
                                            sweep_stale)
from repro_torch.runtime.fault import HeartbeatMonitor, RestartPolicy, StragglerDetector
from repro_torch.runtime.train_loop import run_training

DEAD_PID = 2 ** 22 + 12345  # above any default pid_max: os.kill(pid, 0) fails


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


# ------------------------------------------------------------------ checkpoint
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    assert latest_step(str(tmp_path)) == 7
    restored, manifest = restore_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 7 and manifest["extra"]["note"] == "x"
    np.testing.assert_array_equal(np.asarray(restored["a"]), np.asarray(tree["a"]))
    assert restored["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_atomic_no_partial(tmp_path):
    tree = {"x": torch.zeros((8,))}
    save_checkpoint(str(tmp_path), 1, tree)
    # only final dirs are visible, no .tmp litter
    names = [p.name for p in tmp_path.iterdir()]
    assert names == ["step_00000001"]
    assert (tmp_path / "step_00000001" / "manifest.json").exists()


def test_async_checkpointer_gc_and_wait(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), max_to_keep=2)
    for s in range(4):
        ck.save(s, {"w": torch.full((4,), float(s))})
    ck.wait()
    steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.iterdir())
    assert steps == [2, 3]


def test_restore_dtype_cast(tmp_path):
    tree = {"w": torch.ones((8, 4), dtype=torch.float32)}
    save_checkpoint(str(tmp_path), 0, tree)
    template = {"w": torch.zeros((8, 4), dtype=torch.bfloat16)}
    restored, _ = restore_checkpoint(str(tmp_path), template)
    assert restored["w"].dtype == torch.bfloat16


def test_checkpoint_replace_over_existing(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4,))})
    save_checkpoint(str(tmp_path), 1, {"w": torch.full((4,), 9.0)})
    restored, _ = restore_checkpoint(str(tmp_path), {"w": torch.zeros((4,))})
    np.testing.assert_array_equal(np.asarray(restored["w"]), np.full((4,), 9.0))
    # rename-aside leftovers are cleaned up on the happy path
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000001"]


def test_checkpoint_crash_between_rename_aside_and_commit(tmp_path):
    # planted failure for the old rmtree→replace window: the writer died
    # after moving the good checkpoint aside but before committing the new
    # one — the step must NOT be lost
    tree = {"w": torch.arange(4.0)}
    save_checkpoint(str(tmp_path), 2, tree)
    os.replace(tmp_path / "step_00000002",
               tmp_path / f".old_step_00000002_{DEAD_PID}")
    assert latest_step(str(tmp_path)) == 2  # repaired from the aside copy
    restored, manifest = restore_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 2
    np.testing.assert_array_equal(np.asarray(restored["w"]), np.arange(4.0))


def test_stale_tmp_dirs_from_dead_writers_swept(tmp_path):
    (tmp_path / f".tmp_step_00000005_{DEAD_PID}").mkdir(parents=True)
    mine = tmp_path / f".tmp_step_00000006_{os.getpid()}"
    mine.mkdir(parents=True)
    assert sweep_stale(str(tmp_path)) == 1
    assert mine.exists()  # a LIVE writer's staging dir is never touched
    ck = AsyncCheckpointer(str(tmp_path), max_to_keep=2)
    (tmp_path / f".tmp_step_00000007_{DEAD_PID}").mkdir(parents=True)
    ck.save(0, {"w": torch.zeros((2,))}, blocking=True)  # _gc sweeps too
    names = {p.name for p in tmp_path.iterdir()}
    assert f".tmp_step_00000007_{DEAD_PID}" not in names


def test_restore_falls_back_past_corrupt_newest(tmp_path):
    tree = {"w": torch.ones((4,))}
    save_checkpoint(str(tmp_path), 1, {"w": torch.full((4,), 1.0)})
    save_checkpoint(str(tmp_path), 2, {"w": torch.full((4,), 2.0)})
    corrupt_checkpoint(str(tmp_path))                      # newest = 2
    restored, manifest = restore_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 1
    np.testing.assert_array_equal(np.asarray(restored["w"]), np.full((4,), 1.0))
    # truncation (torn write) degrades the same way
    save_checkpoint(str(tmp_path), 3, {"w": torch.full((4,), 3.0)})
    corrupt_checkpoint(str(tmp_path), truncate=True)       # newest = 3
    _, manifest = restore_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 1
    # an explicitly requested corrupt step still raises
    with pytest.raises(Exception):
        restore_checkpoint(str(tmp_path), tree, step=3)


def test_async_checkpointer_error_surfaces_on_wait(tmp_path):
    root = tmp_path / "not_a_dir"
    root.write_text("a file where the checkpoint root should be")
    ck = AsyncCheckpointer(str(root))
    ck.save(0, {"w": torch.zeros((2,))})  # worker hits the bad root
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # error is raised once, not latched forever


# ----------------------------------------------------------------------- fault
def test_heartbeat_detects_dead_and_recovery():
    hb = HeartbeatMonitor(n_hosts=3, timeout_s=10.0)
    for h in range(3):
        hb.beat(h, now=0.0)
    assert hb.check(now=5.0) == []
    hb.beat(0, now=11.0)
    hb.beat(1, now=11.0)
    events = hb.check(now=12.0)
    assert [e.host for e in events if e.kind == "dead"] == [2]
    ev = hb.beat(2, now=13.0)
    assert ev.kind == "recovered"


def test_straggler_detection():
    sd = StragglerDetector(n_hosts=4, factor=1.5, min_steps=4)
    for step in range(8):
        for h in range(4):
            sd.record(h, step, 1.0 if h != 3 else 2.5)
    out = sd.stragglers()
    assert [e.host for e in out] == [3]


def test_restart_policy_escalation():
    rp = RestartPolicy(max_restarts=2)
    a1 = rp.next_action(spare_hosts=1)
    assert a1["action"] == "restart_with_spare"
    a2 = rp.next_action(spare_hosts=0)
    assert a2["action"] == "elastic_downscale"
    assert rp.next_action(spare_hosts=1)["action"] == "abort"


def test_heartbeat_flags_host_that_never_beat():
    # planted failure: a host that wedges BEFORE its first heartbeat used to
    # be invisible (check() skipped never-seen hosts)
    hb = HeartbeatMonitor(n_hosts=2, timeout_s=10.0, now=0.0)
    hb.beat(0, now=8.0)
    events = hb.check(now=11.0)
    assert [e.host for e in events if e.kind == "dead"] == [1]


def test_straggler_recovered_event():
    sd = StragglerDetector(n_hosts=2, factor=1.5, min_steps=4)
    for step in range(8):
        sd.record(0, step, 1.0)
        sd.record(1, step, 4.0)
    assert [(e.kind, e.host) for e in sd.stragglers()] == [("straggler", 1)]
    for step in range(8, 8 + 16):  # a full window of healthy steps
        sd.record(0, step, 1.0)
        sd.record(1, step, 1.0)
    kinds = [(e.kind, e.host) for e in sd.stragglers()]
    assert ("recovered", 1) in kinds
    assert all(k != "straggler" for k, _ in kinds)


def test_restart_budget_decays_after_healthy_interval():
    # planted failure: the budget never decayed, so a weeks-long job aborted
    # on its Nth TRANSIENT fault no matter how far apart the faults were
    rp = RestartPolicy(max_restarts=2, decay_after_s=100.0)
    assert rp.next_action(1, now=0.0)["action"] == "restart_with_spare"
    assert rp.next_action(1, now=1.0)["action"] == "restart_with_spare"
    assert rp.next_action(1, now=2.0)["action"] == "abort"  # crash loop: abort
    # 250s healthy forgives 2 restarts: the next transient fault restarts
    a = rp.next_action(1, now=252.0)
    assert a["action"] == "restart_with_spare"
    assert a["backoff_s"] == rp.base_backoff_s  # backoff reset with the budget


# ------------------------------------------------------------------------ data
def test_batcher_deterministic_and_resumable():
    c = SyntheticCorpus(vocab_size=1000, seed=3)
    b1 = PackedBatcher(c, global_batch=4, seq_len=64)
    b2 = PackedBatcher(c, global_batch=4, seq_len=64)
    x1, x2 = b1.batch_at(5), b2.batch_at(5)
    np.testing.assert_array_equal(x1["tokens"], x2["tokens"])
    np.testing.assert_array_equal(x1["labels"], x2["labels"])
    # different steps differ
    assert not np.array_equal(b1.batch_at(6)["tokens"], x1["tokens"])


def test_batcher_host_slicing():
    c = SyntheticCorpus(vocab_size=1000, seed=3)
    full = PackedBatcher(c, 8, 32).batch_at(0)
    lo = PackedBatcher(c, 8, 32, host_slice=(0, 4)).batch_at(0)
    hi = PackedBatcher(c, 8, 32, host_slice=(4, 8)).batch_at(0)
    np.testing.assert_array_equal(np.concatenate([lo["tokens"], hi["tokens"]]), full["tokens"])


def test_prefetching_batcher_bit_identical():
    c = SyntheticCorpus(vocab_size=500, seed=1)
    pb = PackedBatcher(c, global_batch=4, seq_len=32)
    pf = PrefetchingBatcher(PackedBatcher(c, global_batch=4, seq_len=32),
                            settings={"prefetch_depth": 3, "pack_workers": 3})
    try:
        for step in (0, 1, 2, 7, 3):  # sequential, ahead, and backwards (resume)
            want = pb.batch_at(step)
            got = pf.batch_at(step)
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            np.testing.assert_array_equal(got["labels"], want["labels"])
    finally:
        pf.close()
    assert pf.counters["hits"] + pf.counters["misses"] == 5


def test_labels_are_next_token_within_doc():
    c = SyntheticCorpus(vocab_size=100, seed=0)
    b = PackedBatcher(c, 1, 128)
    x = b.batch_at(0)
    toks, labs = x["tokens"][0], x["labels"][0]
    for i in range(127):
        if labs[i] >= 0:
            assert labs[i] == toks[i + 1]


# ------------------------------------------------------------------ train loop
def test_training_decreases_loss_and_resumes(tmp_path):
    from repro_torch.runtime.steps import TrainHyper

    cfg = get_config("olmo-1b").reduced().validate()
    hyper = TrainHyper(base_lr=5e-3, warmup=2, total=50)
    out = run_training(cfg, n_steps=8, global_batch=4, seq_len=32, hyper=hyper,
                       ckpt_dir=str(tmp_path / "ck"), ckpt_every=4, seed=0, device="cpu")
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]  # random-init next-token loss drops fast
    # resume: continues from the checkpoint, not from scratch
    out2 = run_training(cfg, n_steps=10, global_batch=4, seq_len=32, hyper=hyper,
                        ckpt_dir=str(tmp_path / "ck"), ckpt_every=4, seed=0, device="cpu")
    assert len(out2["history"]) == 2  # steps 8..9 only
    assert int(out2["state"]["step"]) == 10


def test_final_save_not_duplicated_and_no_stale_clobber(tmp_path):
    # planted failure for the unconditional exit save: (a) a step that was
    # just checkpointed in-loop was written twice; (b) a resume starting AT
    # or past n_steps clobbered step n_steps-1 with the restored state
    cfg = get_config("olmo-1b").reduced().validate()
    ck = str(tmp_path / "ck")
    out = run_training(cfg, n_steps=4, global_batch=2, seq_len=16,
                       ckpt_dir=ck, ckpt_every=4, seed=0, device="cpu")
    assert out["ckpt_counters"]["saves"] == 1  # step 3 saved once, not twice
    manifest = (tmp_path / "ck" / "step_00000003" / "manifest.json")
    before = manifest.stat().st_mtime_ns
    out2 = run_training(cfg, n_steps=4, global_batch=2, seq_len=16,
                        ckpt_dir=ck, ckpt_every=4, seed=0, device="cpu")
    assert out2["history"] == []  # start=4 >= n_steps: nothing to train
    assert out2["ckpt_counters"]["saves"] == 0  # and nothing re-written
    assert manifest.stat().st_mtime_ns == before


def test_train_loop_telemetry_and_fault_wiring(tmp_path):
    from repro_torch.core.channel import MlosChannel
    from repro_torch.core.codegen import unpack_telemetry
    from repro_torch.core.registry import get_component
    from repro_torch.runtime.fault import FaultEvent

    cfg = get_config("olmo-1b").reduced().validate()
    chan = MlosChannel.create(capacity=1 << 16)
    try:
        # a shared detector pre-loaded with a fleet where host 1 lags: the
        # loop's own step recordings land on host 0, and the periodic
        # stragglers() sweep must dispatch the events to on_fault
        sd = StragglerDetector(n_hosts=2, factor=1.5, min_steps=4)
        for step in range(8):
            sd.record(1, step, 60.0)
        faults = []
        out = run_training(cfg, n_steps=8, global_batch=2, seq_len=16,
                           channel=chan, straggler_detector=sd,
                           on_fault=faults.append, seed=0,
                           device="cpu")
        meta = get_component("torch_train_loop")
        rows = []
        while True:
            payload = chan.telemetry.pop()
            if payload is None:
                break
            rows.append(unpack_telemetry(meta, payload))
        assert len(rows) == 8  # one packed record per step reached the channel
        losses = [h["loss"] for h in out["history"]]
        assert [r["loss"] for r in rows] == pytest.approx(losses)
        assert any(e.kind == "straggler" and e.host == 1 for e in faults)
        assert all(isinstance(e, FaultEvent) for e in faults)
    finally:
        chan.close()


@pytest.mark.slow
def test_kill_between_checkpoints_resumes_bit_identical(tmp_path):
    """SIGKILL mid-run (chaos), respawn, and the merged loss trajectory is
    bit-identical to an uninterrupted run — PackedBatcher.batch_at is
    stateless, so the resumed stream has zero drift."""
    from repro_torch.runtime.chaos import respawn

    child = tmp_path / "child.py"
    child.write_text(
        "import json, sys\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.runtime.chaos import ChaosInjector, Fault\n"
        "from repro_torch.runtime.train_loop import run_training\n"
        "d, mode = sys.argv[1], sys.argv[2]\n"
        "chaos = (ChaosInjector([Fault(5, 'kill')], journal=d + '/chaos.jsonl')\n"
        "         if mode == 'kill' else None)\n"
        "cfg = get_config('olmo-1b').reduced().validate()\n"
        "# per-step write + flush: SIGKILL loses process buffers, not the\n"
        "# OS page cache, so flushed lines from before the kill survive\n"
        "f = open(d + '/losses_' + mode + '.jsonl', 'a')\n"
        "def log(s, m):\n"
        "    f.write(json.dumps({'step': s, 'loss': m['loss']}) + '\\n')\n"
        "    f.flush()\n"
        "run_training(cfg, n_steps=8, global_batch=2, seq_len=16,\n"
        "             ckpt_dir=d + '/ck_' + mode, ckpt_every=2, chaos=chaos,\n"
        "             on_step=log, seed=0, device='cpu')\n"
        "f.close()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    restarts = respawn([sys.executable, str(child), str(tmp_path), "kill"],
                       max_restarts=2, env=env)
    assert restarts == 1  # exactly the one scheduled kill
    respawn([sys.executable, str(child), str(tmp_path), "ref"],
            max_restarts=0, env=env)
    ref, killed = {}, {}
    for line in (tmp_path / "losses_ref.jsonl").read_text().splitlines():
        r = json.loads(line)
        ref[r["step"]] = r["loss"]
    for line in (tmp_path / "losses_kill.jsonl").read_text().splitlines():
        r = json.loads(line)
        if r["step"] in killed:  # re-executed after resume: must not diverge
            assert killed[r["step"]] == r["loss"]
        killed[r["step"]] = r["loss"]
    assert killed == ref  # bit-identical, dict equality is exact float equality


# ------------------------------------------------------------------ chaos plans
def test_generators_are_seeded_and_sorted():
    for name, gen in SCENARIOS.items():
        a, b = gen(11, n_steps=32), gen(11, n_steps=32)
        assert a == b, name  # same seed, same plan — replayable by contract
        assert a != gen(12, n_steps=32), name
        assert [f.at_step for f in a] == sorted(f.at_step for f in a), name
        assert all(f.at_step >= 1 for f in a), name  # never step 0


def test_kills_distinct_steps_and_clamped():
    plan = kills(3, n_steps=64, n_kills=4)
    steps = [f.at_step for f in plan]
    assert len(set(steps)) == 4 and all(f.kind == "kill" for f in plan)
    # more kills than steps available: clamped, not an error
    tiny = kills(3, n_steps=3, n_kills=10)
    assert len(tiny) <= 2 and all(1 <= f.at_step < 3 for f in tiny)


def test_mixed_covers_every_kind_on_disjoint_steps():
    plan = mixed(5, n_steps=64)
    assert sorted(f.kind for f in plan) == sorted(
        ("kill", "suspend", "corrupt_ckpt", "truncate_ckpt", "data_delay"))
    assert len({f.at_step for f in plan}) == len(plan)


def test_plan_json_roundtrip():
    plan = mixed(9, n_steps=64)
    back = plan_from_json(plan_to_json(plan))
    assert back == plan
    assert all(isinstance(f, Fault) for f in back)


# --------------------------------------------------------- fire-once journal
def test_fault_fires_once_within_a_process(tmp_path):
    inj = ChaosInjector([Fault(2, "suspend", 0.0), Fault(2, "data_delay", 0.0)],
                        journal=str(tmp_path / "j.jsonl"))
    inj.on_step(1)
    assert inj.fired == set()
    inj.on_step(2)
    assert len(inj.fired) == 2  # both step-2 faults, distinct ids
    inj.on_step(2)  # a re-executed step must not re-fire
    assert len(inj.fired) == 2
    rows = [json.loads(line) for line in
            (tmp_path / "j.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and all(r["step"] == 2 for r in rows)


def test_journal_survives_injector_reconstruction(tmp_path):
    """The respawned-process contract: a new injector over the same journal
    skips already-fired faults — this is what stops a kill loop."""
    j = str(tmp_path / "j.jsonl")
    plan = [Fault(1, "suspend"), Fault(3, "suspend")]
    first = ChaosInjector(plan, journal=j)
    first.on_step(1)
    reborn = ChaosInjector(plan, journal=j)  # same plan, fresh process
    assert reborn.fired == first.fired
    reborn.on_step(1)  # resume re-executes step 1: must be a no-op
    assert reborn.fired == first.fired
    reborn.on_step(3)
    assert len(reborn.fired) == 2


def test_no_journal_means_in_memory_only(tmp_path):
    inj = ChaosInjector([Fault(1, "suspend")])
    inj.on_step(1)
    assert len(inj.fired) == 1
    assert list(tmp_path.iterdir()) == []  # nothing written anywhere


def test_unknown_fault_kind_raises():
    inj = ChaosInjector([Fault(1, "meteor_strike")])
    with pytest.raises(ValueError, match="meteor_strike"):
        inj.on_step(1)


# ------------------------------------------------------------- damage paths
def _tree(v: float):
    return {"w": np.full((16, 16), v, dtype=np.float32)}


def test_corrupt_checkpoint_targets_newest_and_restore_falls_back(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 1, _tree(1.0))
    save_checkpoint(root, 2, _tree(2.0))
    hit = corrupt_checkpoint(root)
    assert hit is not None and "step_00000002" in str(hit)
    state, manifest = restore_checkpoint(root, _tree(0.0))
    assert manifest["step"] == 1  # newest is torn; fallback is transparent


def test_corrupt_checkpoint_explicit_step_and_truncate(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 1, _tree(1.0))
    save_checkpoint(root, 2, _tree(2.0))
    npz = corrupt_checkpoint(root, step=1, truncate=True)
    assert npz is not None and "step_00000001" in str(npz)
    assert npz.stat().st_size > 0  # torn, not deleted
    # newest untouched: restore still succeeds at step 2
    state, manifest = restore_checkpoint(root, _tree(0.0))
    assert manifest["step"] == 2


def test_corrupt_checkpoint_nothing_to_damage(tmp_path):
    assert corrupt_checkpoint(str(tmp_path)) is None
    assert latest_step(str(tmp_path)) is None


def test_injector_routes_damage_to_ckpt_dir(tmp_path):
    root = str(tmp_path / "ck")
    save_checkpoint(root, 0, _tree(3.0))
    inj = ChaosInjector([Fault(4, "corrupt_ckpt")])
    inj.on_step(4, ckpt_dir=root)
    with pytest.raises(Exception):
        restore_checkpoint(root, _tree(0.0), step=0)
    # without a ckpt_dir the same fault is a structured no-op, not a crash
    ChaosInjector([Fault(4, "truncate_ckpt")]).on_step(4, ckpt_dir=None)


# --------------------------------------------------------------- supervisor
def test_respawn_counts_scheduled_deaths(tmp_path):
    """Child SIGKILLs itself until a marker file accumulates 2 lines; the
    supervisor must report exactly 2 restarts and a final clean exit."""
    marker = tmp_path / "deaths"
    prog = (
        "import os, signal, sys\n"
        f"p = {str(marker)!r}\n"
        "n = len(open(p).readlines()) if os.path.exists(p) else 0\n"
        "if n < 2:\n"
        "    with open(p, 'a') as f:\n"
        "        f.write('x\\n')\n"
        "        f.flush()\n"
        "        os.fsync(f.fileno())\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n"
        "sys.exit(0)\n")
    restarts = respawn([sys.executable, "-c", prog], max_restarts=4)
    assert restarts == 2
    assert marker.read_text().count("x") == 2


def test_respawn_refuses_a_crash_loop():
    with pytest.raises(RuntimeError, match="giving up"):
        respawn([sys.executable, "-c", "import sys; sys.exit(3)"],
                max_restarts=1)


# ------------------------------------------------------------ the port's own
def test_checkpoint_layout_matches_the_reference(tmp_path):
    """``step_<k:08d>/{manifest.json, arrays.npz}``; keys are paths joined
    by "/" (dict keys sorted, list items by index); a bf16 leaf is stored as
    its uint16 bits under ``key + "::bf16"``, so numpy reads it without
    ml_dtypes."""
    w = torch.randn(3, 4).to(torch.bfloat16)
    tree = {"params": {"blocks": [{"w": w}], "embed": torch.ones(2)},
            "step": torch.tensor(4, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 12, tree)
    d = tmp_path / "step_00000012"
    assert sorted(p.name for p in d.iterdir()) == ["arrays.npz", "manifest.json"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["keys"] == ["params/blocks/0/w::bf16", "params/embed", "step"]
    with np.load(d / "arrays.npz") as z:
        bits = z["params/blocks/0/w::bf16"]
        assert bits.dtype == np.uint16
        np.testing.assert_array_equal(bits, w.view(torch.int16).numpy().view(np.uint16))
    back, _ = restore_checkpoint(str(tmp_path), tree)
    assert back["params"]["blocks"][0]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["blocks"][0]["w"], w)
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 4


def test_restore_takes_the_template_device_and_dtype(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"w": torch.arange(4.0)})
    back, _ = restore_checkpoint(str(tmp_path), {"w": torch.zeros(4, dtype=torch.float64,
                                                                  device="meta")})
    assert back["w"].device.type == "meta" and back["w"].dtype == torch.float64


def test_async_save_snapshots_before_returning(tmp_path):
    """The train step updates its tensors in place: what ``save`` returns
    from is already the host copy, so a later in-place write does not reach
    the checkpoint that is still being written."""
    w = torch.zeros(256, 256)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(0, {"w": w})
    w.fill_(7.0)
    ck.wait()
    back, _ = restore_checkpoint(str(tmp_path), {"w": torch.empty(256, 256)})
    assert float(back["w"].abs().max()) == 0.0


def test_pipeline_gives_the_reference_tokens():
    """numpy on both sides: one seed, one token stream."""
    from repro.data.pipeline import PackedBatcher as JBatcher
    from repro.data.pipeline import SyntheticCorpus as JCorpus

    want = JBatcher(JCorpus(vocab_size=777, seed=5), 4, 48).batch_at(9)
    got = PackedBatcher(SyntheticCorpus(vocab_size=777, seed=5), 4, 48).batch_at(9)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


def test_state_size_signature():
    from repro_torch.runtime.checkpoint import state_kb, workload_signature

    tree = {"a": torch.zeros(1024, dtype=torch.float32),
            "b": [torch.zeros(512, dtype=torch.bfloat16)]}
    assert state_kb(tree) == 5 and workload_signature(state_kb(tree)) == "kb8"
