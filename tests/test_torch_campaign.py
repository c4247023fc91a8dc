"""The port's MLOS loop (``repro_torch.core`` stats, optimizers, config
store, agent and campaign; ``repro_torch.launch`` microbench, tuning and
campaign) against the reference's, on the CPU.

Inputs and planted objectives are drawn with numpy from fixed or crc32
seeds; every store and journal lives in ``tmp_path``.  The port's demo
components (``torch_hashtable``, ``torch_spinlock``) are the reference's
under the port's names, so one planted objective drives both packages'
campaigns and their traces must agree exactly.
"""
import json
import math
import zlib

import numpy as np
import pytest

from repro.core import campaign as jcampaign
from repro.core import configstore as jstore
from repro.core import smartcomponents as _jsmart  # noqa: F401 — registers hashtable/spinlock
from repro.core import stats as jstats
from repro.core import tunable as jtunable
from repro.core.optimizers import BayesOpt as JBayesOpt
from repro.core.optimizers import GridSearch as JGridSearch
from repro.core.optimizers import RandomSearch as JRandomSearch
from repro.launch import campaign as jlaunch
from repro_torch.core import campaign as tcampaign
from repro_torch.core import configstore as tstore
from repro_torch.core import stats as tstats
from repro_torch.core import tunable as ttunable
from repro_torch.core.agent import AgentMux, drive_session, make_session, promote_session_report
from repro_torch.core.codegen import pack_telemetry, peek_component_id, unpack_telemetry
from repro_torch.core.optimizers import BayesOpt, GridSearch, RandomSearch, make_optimizer
from repro_torch.core.registry import get_component
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import campaign as tlaunch
from repro_torch.launch import microbench, tuning

PORT_NAMES = {"hashtable": "torch_hashtable", "spinlock": "torch_spinlock"}


def _rng(*tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


# -------------------------------------------------------------------- stats
@pytest.mark.parametrize("n_a,n_b,shift,noise", [
    (5, 5, 0.30, 0.05), (5, 5, 0.01, 0.05), (8, 8, -0.2, 0.1), (3, 3, 0.5, 0.01),
    (1, 6, 0.3, 0.05), (12, 9, 0.06, 0.02), (2, 2, 0.4, 0.0)])
@pytest.mark.parametrize("mode", ["min", "max"])
def test_compare_matches_reference(n_a, n_b, shift, noise, mode):
    rng = _rng("cmp", n_a, n_b, shift, noise)
    a = (100.0 * (1 + noise * rng.standard_normal(n_a))).tolist()
    b = (100.0 * (1 + shift + noise * rng.standard_normal(n_b))).tolist()
    got, want = tstats.compare(a, b, mode=mode), jstats.compare(a, b, mode=mode)
    assert got.to_dict() == want.to_dict()


def test_measure_adaptive_and_streaming_ab_match_reference():
    vals = iter(_rng("adaptive").uniform(9, 11, 64).tolist())
    vals2 = iter(list(_rng("adaptive").uniform(9, 11, 64)))
    got = tstats.measure_adaptive(lambda: next(vals), target_rel_ci=0.02, max_reps=40)
    want = jstats.measure_adaptive(lambda: next(vals2), target_rel_ci=0.02, max_reps=40)
    assert got.to_dict() == want.to_dict()
    t, j = tstats.StreamingAB(min_pairs=3), jstats.StreamingAB(min_pairs=3)
    for x, y in _rng("ab").uniform(1, 2, (6, 2)):
        assert t.add_pair(x, 1.3 * y).to_dict() == j.add_pair(x, 1.3 * y).to_dict()
        assert t.decided == j.decided
    assert tstats.bootstrap_ci([1.0, 3.0, 2.0, 5.0]) == jstats.bootstrap_ci([1.0, 3.0, 2.0, 5.0])


# --------------------------------------------------------------- optimizers
def _spaces():
    def build(m):
        return m.TunableSpace([
            m.Int("n", default=8, low=1, high=256, log=True),
            m.Float("x", default=0.5, low=0.0, high=1.0),
            m.Categorical("c", default="b", choices=("a", "b", "c")),
        ])
    return build(ttunable), build(jtunable)


def _planted(cfg):
    return (math.log2(cfg["n"]) - 5.0) ** 2 + 3 * (cfg["x"] - 0.3) ** 2 + (cfg["c"] != "c")


@pytest.mark.parametrize("kind", ["random", "grid", "bo"])
@pytest.mark.parametrize("with_prior", [False, True])
def test_optimizers_propose_the_reference_configs(kind, with_prior):
    tspace, jspace = _spaces()
    make = {"random": (RandomSearch, JRandomSearch), "grid": (GridSearch, JGridSearch),
            "bo": (BayesOpt, JBayesOpt)}[kind]
    t, j = make[0](tspace, seed=11), make[1](jspace, seed=11)
    if with_prior:
        prior = [({"n": 4, "x": 0.2, "c": "a"}, 2.5), ({"n": 64, "x": 0.9, "c": "c"}, 4.0)]
        assert t.inject_prior(prior) == j.inject_prior(prior)
    for _ in range(8):
        ct, cj = t.ask(), j.ask()
        assert ct == cj
        t.tell(ct, _planted(ct))
        j.tell(cj, _planted(cj))
    assert t.best.config == j.best.config and t.best.value == j.best.value


def test_bayesopt_has_only_the_numpy_backend():
    tspace, _ = _spaces()
    with pytest.raises(ValueError):
        BayesOpt(tspace, backend="jax")
    for name in ("bo_jax", "bo_jax_rbf"):
        with pytest.raises(ValueError):
            make_optimizer(name, tspace)
    assert make_optimizer("bo", tspace).backend == "numpy"
    with pytest.raises(ValueError):
        tuning.parse_override("optimizer.backend=jax")
    assert tuning.parse_override("optimizer.backend=numpy") == {"optimizer": {"backend": "numpy"}}


# -------------------------------------------------------------------- store
@pytest.mark.parametrize("a,b", [
    ("b2q512k512d64", "b2q512k512d64"), ("b2q512k512d64", "b2q1024k1024d64"),
    ("b2q512k512d64", "r512d64"), ("s128", "s1024"), ("*", "s128"), ("olmo-1b_c256", "gpt-3b_c256"),
    ("olmo_c256", "olmo_c512"), ("r2048d1536", "r16384d1536"), ("b1s256h48", "b2s512h48")])
def test_workload_distance_matches_reference(a, b):
    assert tstore.workload_distance(a, b) == jstore.workload_distance(a, b)
    assert tstore._sig_fields(a) == jstore._sig_fields(a)


def _put_both(stores, comp, wl, hw, settings, when):
    (ts, js) = stores
    ts.put(tstore.Context(comp, wl, hw, "sw0"), settings, {"updated": when})
    js.put(jstore.Context(comp, wl, hw, "sw0"), settings, {"updated": when})


def test_nearest_entry_and_resolution_match_reference(tmp_path):
    stores = (tstore.ConfigStore(tmp_path / "t"), jstore.ConfigStore(str(tmp_path / "j")))
    q = ("flash_attention", "b2q512k512d64", "cpu:a:x1", "sw0")
    assert stores[0].nearest_entry(tstore.Context(*q)) is None
    _put_both(stores, "flash_attention", "b2q128k128d64", "cpu:a:x1", {"block_q": 128}, 1.0)
    _put_both(stores, "flash_attention", "b2q256k256d64", "cpu:b:x1", {"block_q": 256}, 2.0)
    for max_d in (math.inf, 1.0, 2.0):
        got = stores[0].nearest_entry(tstore.Context(*q), max_distance=max_d)
        want = stores[1].nearest_entry(jstore.Context(*q), max_distance=max_d)
        assert (got is None) == (want is None)
        if got is not None:
            assert got[0]["settings"] == want[0]["settings"] and got[1] == want[1]
    _put_both(stores, "flash_attention", "*", "cpu:b:x1", {"block_q": 64}, 3.0)
    _put_both(stores, "flash_attention", "b2q512k512d64", "cpu:b:x1", {"block_q": 512}, 4.0)
    for wl in ("b2q512k512d64", "b1q8k8d64", "*"):
        got = stores[0].resolve(tstore.Context("flash_attention", wl, "cpu:a:x1", "sw0"))
        want = stores[1].resolve(jstore.Context("flash_attention", wl, "cpu:a:x1", "sw0"))
        assert got == want


@pytest.mark.parametrize("shift,accepted", [(-0.3, True), (0.0, True), (0.4, False)])
def test_promote_gate_matches_reference(tmp_path, shift, accepted):
    rng = _rng("gate", shift)
    base = (100 * (1 + 0.02 * rng.standard_normal(8))).tolist()
    samples = (100 * (1 + shift + 0.02 * rng.standard_normal(8))).tolist()
    ts, js = tstore.ConfigStore(tmp_path / "t"), jstore.ConfigStore(str(tmp_path / "j"))
    ctx = ("flash_attention", "b1q128k128d128", "cpu:a:x1", "sw0")
    got = ts.promote(tstore.Context(*ctx), {"block_q": 32}, baseline=base, samples=samples)
    want = js.promote(jstore.Context(*ctx), {"block_q": 32}, baseline=base, samples=samples)
    assert got == want == accepted
    if accepted:
        tg = ts.resolve_entry(tstore.Context(*ctx))["provenance"]["gate"]
        jg = js.resolve_entry(jstore.Context(*ctx))["provenance"]["gate"]
        assert tg == jg
    else:
        assert ts.resolve_entry(tstore.Context(*ctx)) is None


def test_a_cpu_entry_never_resolves_on_the_card(tmp_path):
    """The port's one deviation: the hardware platform disqualifies."""
    st = tstore.ConfigStore(tmp_path / "s")
    cpu = tstore.Context("torch_flash_attention", "b1q128k128d128", "cpu:x86_64:x1", "sw")
    st.put(cpu, {"impl": "unrolled"})
    card = tstore.Context("torch_flash_attention", "b1q128k128d128",
                          "cuda:NVIDIA_H100_80GB_HBM3:x1", "sw")
    assert st.resolve(card) is None
    assert st.nearest_entry(card) is None
    assert st.nearest_entry(tstore.Context("torch_flash_attention", "b1q256k256d128",
                                           card.hardware, "sw")) is None
    assert st.resolve(tstore.Context(cpu.component, cpu.workload, "cpu:aarch64:x1", "sw2")) \
        == {"impl": "unrolled"}            # the same platform only ranks lower
    st.put(tstore.Context("torch_flash_attention", "*", "*", "*"), {"block_q": 32})
    assert st.resolve(card) == {"block_q": 32}      # a wildcard entry serves every platform
    assert tstore.platform_of("cuda:NVIDIA_H100_80GB_HBM3:x1") == "cuda"


def test_reference_and_port_stores_share_a_root(tmp_path):
    """One root, one workload: each package resolves its own entry (the
    port's components carry ``torch_`` names, so their files differ)."""
    root = tmp_path / "shared"
    ts, js = tstore.ConfigStore(root), jstore.ConfigStore(str(root))
    wl = "b1q128k128d128"
    js.put(jstore.context_for("flash_attention", wl), {"impl": "unrolled", "block_q": 256})
    ts.put(tstore.context_for("torch_flash_attention", wl), {"impl": "kernel", "block_q": 32})
    assert ts.resolve(tstore.context_for("torch_flash_attention", wl))["block_q"] == 32
    assert js.resolve(jstore.context_for("flash_attention", wl))["block_q"] == 256
    assert sorted(p.name for p in root.glob("*.json")) == ["flash_attention.json",
                                                            "torch_flash_attention.json"]


@pytest.fixture
def default_store(tmp_path):
    store = tstore.ConfigStore(tmp_path / "cs")
    old = tstore.set_default_store(store)
    yield store
    tstore.set_default_store(old)


def test_store_tier_sits_between_explicit_and_defaults(default_store):
    wl = "r2048d1536"
    ctx = tstore.context_for("torch_rmsnorm_kernel", wl)
    assert rms_ops.rmsnorm_settings.settings_for(wl)["block_rows"] == 1
    default_store.put(ctx, {"block_rows": 16, "row_threads": 64, "stale_key": 1})
    assert rms_ops.rmsnorm_settings.settings_for(wl) == {
        "impl": "kernel", "block_rows": 16, "row_threads": 64}
    inst = rms_ops.RmsNormSettings(block_rows=2)               # explicit beats stored
    assert inst.settings_for(wl)["block_rows"] == 2 and inst.settings_for(wl)["row_threads"] == 64
    tstore.set_override("torch_rmsnorm_kernel", wl, {"block_rows": 8})   # override beats all
    try:
        assert inst.settings_for(wl)["block_rows"] == 8
    finally:
        tstore.clear_override("torch_rmsnorm_kernel", wl)
    default_store.put(ctx, {"block_rows": 3})                  # out of domain: dropped
    assert rms_ops.rmsnorm_settings.settings_for(wl)["block_rows"] == 1


# ------------------------------------------------------------ agent, wire
def test_telemetry_round_trip_and_mux_routing():
    meta = get_component("torch_hashtable")
    payload = pack_telemetry(meta, 3, {"time_us": 1.5, "collisions": 7, "memory_bytes": 8,
                                       "load_factor_ppm": 9})
    assert peek_component_id(payload) == meta.component_id
    assert unpack_telemetry(meta, payload)["collisions"] == 7
    s = make_session(meta, "collisions", workload="n1024l2", budget=3, seed=1, instance_id=3)
    mux = AgentMux([s])
    assert mux.observe(b"\x00" * 3) == [] and mux.unrouted == 1
    cmds = mux.start_commands()
    assert json.loads(cmds[0])["type"] == "config_update"
    core = drive_session(s, lambda cfg: {"time_us": 1.0, "collisions": cfg["probe_stride"],
                                         "memory_bytes": 0, "load_factor_ppm": 0})
    assert core.done and core.evaluations == 3
    report = json.loads(core.session_report())
    assert report["context"]["hardware"] == tstore.hardware_fingerprint()


def test_promote_session_report_keys_the_entry_by_context(tmp_path):
    st = tstore.ConfigStore(tmp_path / "s")
    msg = {"context": tstore.context_for("torch_spinlock", "heavy2").to_dict(),
           "best_config": {"max_spin": 100}, "best_value": -5.0, "mode": "max",
           "objective": "throughput_ops_s", "budget": 4, "evaluations": 4}
    assert promote_session_report(st, msg)
    entry = st.resolve_entry(tstore.context_for("torch_spinlock", "heavy2"))
    assert entry["provenance"]["best_objective"] == 5.0
    assert not promote_session_report(st, dict(msg, context=None))


# ---------------------------------------------------------------- campaigns
def _planted_measure(seed=1, drift=0.05):
    """Deterministic objective per (component, workload): squared distance
    in encoded space to an optimum that drifts with the workload's first
    signature field.  The spinlock maximizes, so the mode flip has to
    survive warm start and promotion."""
    spaces = {c: get_component(PORT_NAMES[c]).space for c in ("hashtable", "spinlock")}
    bases = {c: np.random.default_rng(seed + i).uniform(0.3, 0.7, len(spaces[c]))
             for i, c in enumerate(spaces)}

    def measure(cell, settings):
        comp = "spinlock" if "spinlock" in cell.component else "hashtable"
        space = spaces[comp]
        field = next(iter(tstore._sig_fields(cell.workload).values()))
        t = np.clip(bases[comp] + drift * math.log2(field), 0, 1)
        d2 = float(np.sum((space.encode(space.validate(settings)) - t) ** 2))
        if comp == "spinlock":
            return {"throughput_ops_s": 1e6 / (1.0 + d2), "wasted_spin_ns": 0, "parks": 0}
        v = d2 * 1000.0
        return {"time_us": v, "collisions": int(v), "memory_bytes": 0, "load_factor_ppm": 0}

    return measure


def _run_both(tmp_path, grid_subset, measure_kind, tag, budget=6):
    """The demo grid (or a subset of its workloads) through the reference's
    and the port's Campaign, each into its own store and journal."""
    out = []
    for pkg, launch, camp, store_mod in (("j", jlaunch, jcampaign, jstore),
                                         ("t", tlaunch, tcampaign, tstore)):
        kw = {} if pkg == "j" else {"device": "cpu"}
        cells = [c for c in launch.grid_cells("demo", budget=budget, optimizer="bo", seed=0, **kw)
                 if c.workload in grid_subset]
        measure = (_planted_measure() if measure_kind == "planted"
                   else launch.build_measure(**kw))
        store = store_mod.ConfigStore(str(tmp_path / f"{pkg}_store"))
        c = camp.Campaign(cells, measure, campaign_id=tag, store=store,
                          journal_root=str(tmp_path / f"{pkg}_journal"))
        out.append({cid.split("@")[1]: r for cid, r in c.run().items()})
    return out


@pytest.mark.parametrize("measure_kind", ["planted", "demo"])
def test_demo_grid_campaign_matches_reference(tmp_path, measure_kind):
    """Cold, then warm from nearer workloads: the same value traces, best
    configs, promoted flags and warm-start sources as the reference."""
    all_wl = ["n1024l2", "n2048l2", "n4096l4", "heavy2", "heavy8"]
    for tag, subset in (("first", ["n1024l2", "heavy2"]), ("second", all_wl)):
        want, got = _run_both(tmp_path, subset, measure_kind, tag)
        assert sorted(got) == sorted(want) == sorted(subset)
        for wl in subset:
            g, w = got[wl], want[wl]
            assert g.values == w.values, wl
            assert g.best_config == w.best_config and g.best_value == w.best_value
            assert g.promoted == w.promoted and g.evaluations == w.evaluations
            assert g.warm_start == w.warm_start
    assert got["n4096l4"].warm_start["source_workload"] == "n1024l2"
    assert got["heavy8"].warm_start == {"source_workload": "heavy2", "distance": 2.0,
                                        "n_prior": got["heavy8"].warm_start["n_prior"]}


class _Killed(RuntimeError):
    pass


def _demo_cells(budgets):
    measure_cells = []
    for i, (wl, budget) in enumerate(budgets):
        comp, obj, mode = (("torch_spinlock", "throughput_ops_s", "max") if wl.startswith("heavy")
                           else ("torch_hashtable", "time_us", "min"))
        measure_cells.append(tcampaign.CampaignCell(comp, wl, obj, mode=mode, budget=budget,
                                                    seed=i))
    return measure_cells


def test_resume_after_kill_skips_completed_cells(tmp_path):
    short = _demo_cells([("n1024l2", 3), ("n2048l2", 3)])
    long = _demo_cells([("heavy2", 8), ("heavy8", 8)])
    cells = short + long
    measure = _planted_measure()
    store = tstore.ConfigStore(tmp_path / "s")
    journal = tcampaign.CampaignJournal("kill", root=tmp_path / "j")

    def measure_until_short_done(cell, settings):
        if all(c.cell_id in journal.completed() for c in short):
            raise _Killed("simulated crash mid-campaign")
        return measure(cell, settings)

    with pytest.raises(_Killed):
        tcampaign.Campaign(cells, measure_until_short_done, campaign_id="kill",
                           journal_root=tmp_path / "j", store=store).run()
    done = journal.completed()
    assert all(c.cell_id in done for c in short) and not any(c.cell_id in done for c in long)
    calls = {c.cell_id: 0 for c in cells}

    def counting(cell, settings):
        calls[cell.cell_id] += 1
        return measure(cell, settings)

    results = tcampaign.Campaign(cells, counting, campaign_id="kill", journal_root=tmp_path / "j",
                                 store=store).run()
    for c in short:
        assert calls[c.cell_id] == 0 and results[c.cell_id].resumed
        assert results[c.cell_id].best_config == done[c.cell_id]["best_config"]
    for c in long:
        assert calls[c.cell_id] > 0 and results[c.cell_id].evaluations == c.budget
    # torn and future-version lines are skipped; a full rerun measures nothing
    with open(journal.path, "a") as f:
        f.write('{"schema": 999, "kind": "cell_done", "cell_id": "torch_hashtable@n8l2"}\n')
        f.write('{"truncated mid-wri')
    assert "torch_hashtable@n8l2" not in journal.completed()
    rerun = tcampaign.Campaign(cells, counting, campaign_id="kill", journal_root=tmp_path / "j",
                               store=store)
    before = dict(calls)
    assert all(r.resumed for r in rerun.run().values())
    assert rerun.measure_calls == 0 and calls == before


def test_warm_start_strictly_beats_cold(tmp_path):
    measure = _planted_measure()
    store = tstore.ConfigStore(tmp_path / "s")
    src = [tcampaign.CampaignCell("torch_hashtable", "n128l2", "time_us", budget=12, seed=5)]
    tcampaign.Campaign(src, measure, campaign_id="src", journal_root=tmp_path / "j",
                       store=store).run()
    target = [tcampaign.CampaignCell("torch_hashtable", "n256l2", "time_us", budget=10, seed=40)]
    cold = tcampaign.Campaign(target, measure, campaign_id="cold", journal_root=tmp_path / "j",
                              store=tstore.ConfigStore(tmp_path / "c"),
                              warm_start=False).run()["torch_hashtable@n256l2"]
    warm = tcampaign.Campaign(target, measure, campaign_id="warm", journal_root=tmp_path / "j",
                              store=store).run()["torch_hashtable@n256l2"]
    assert cold.warm_start is None and warm.warm_start["source_workload"] == "n128l2"
    goal = min(cold.best_value, warm.best_value)
    cold_iters = tcampaign.evals_to_reach(cold.values, goal, tol=0.10) or 11
    warm_iters = tcampaign.evals_to_reach(warm.values, goal, tol=0.10)
    assert warm_iters is not None and warm_iters < cold_iters, (warm.values, cold.values)


def test_pinned_cells_search_the_rest_and_refuse_a_contradiction(tmp_path):
    cells = tlaunch.grid_cells("kernels", budget=6, optimizer="bo", seed=0, device="cuda")
    assert [c.workload for c in cells] == [
        "b1q128k128d128", "b2q256k256d128", "b2q512k512d128", "b4q1024k1024d128",
        "r2048d1536", "r16384d1536", "b1s256h48", "b2s512h48"]
    assert [c.seed for c in cells] == [0, 1, 2, 3, 0, 1, 0, 1]
    assert all(dict(c.pin) == {"impl": "kernel"} for c in cells)
    assert all(c.pin == () for c in tlaunch.grid_cells("kernels", budget=6, optimizer="bo",
                                                       seed=0, device="cpu"))
    cell = tcampaign.CampaignCell("torch_rmsnorm_kernel", "r8d64", "time_us", budget=3,
                                  pin=(("impl", "plain"),))
    seen = []

    def measure(c, settings):
        seen.append(settings)
        return {"time_us": float(settings["block_rows"] + settings["row_threads"])}

    r = tcampaign.Campaign([cell], measure, campaign_id="pin", journal_root=tmp_path / "j",
                           store=tstore.ConfigStore(tmp_path / "s")).run()
    assert all(s["impl"] == "plain" for s in seen) and r[cell.cell_id].best_config["impl"] == "plain"
    start = [row for row in tcampaign.CampaignJournal("pin", tmp_path / "j").rows()
             if row["kind"] == "cell_start"]
    assert start[0]["cell"]["pin"] == {"impl": "plain"}
    with pytest.raises(ValueError):
        cell.with_pin({"impl": "kernel", "block_rows": 4})


@pytest.mark.parametrize("noisy", [False, True], ids=["deterministic", "noisy"])
def test_gate_samples_follow_the_measure(tmp_path, noisy):
    """A deterministic measure keeps the reference's gate (the start-of-cell
    baseline against the best's history samples); a noisy one, whose two
    baseline samples differ, is gated on GATE_REPS interleaved default/best
    samples, so the comparator computes a p-value."""
    cell = tcampaign.CampaignCell("torch_rmsnorm_kernel", "r8d64", "time_us", budget=3)
    ticks = iter(range(10_000))
    seen = []

    def measure(c, settings):
        seen.append(settings)
        t = float(10 * settings["block_rows"] + settings["row_threads"] // 32)
        return {"time_us": t + (1e-3 * next(ticks) if noisy else 0.0)}

    r = tcampaign.Campaign([cell], measure, campaign_id="g", journal_root=tmp_path / "j",
                           store=tstore.ConfigStore(tmp_path / "s")).run()[cell.cell_id]
    n_gate = 2 * tcampaign.GATE_REPS if noisy else 0
    assert len(seen) == tcampaign.BASELINE_REPS + r.evaluations + n_gate
    assert len(r.gate["baseline"]) == (tcampaign.GATE_REPS if noisy else tcampaign.BASELINE_REPS)
    assert (r.gate["p_value"] is not None) == noisy
    if noisy:
        defaults = get_component(cell.component).space.defaults()
        assert seen[-n_gate:] == [defaults, r.best_config] * tcampaign.GATE_REPS


# ------------------------------------------- the kernels grid on the CPU
@pytest.mark.parametrize("cell", [
    tcampaign.CampaignCell("torch_flash_attention", "b1q16k16d16", "time_us", budget=3),
    tcampaign.CampaignCell("torch_rmsnorm_kernel", "r8d64", "time_us", budget=3),
    tcampaign.CampaignCell("torch_ssd_kernel", "b1s16h4", "time_us", budget=3),
], ids=lambda c: c.component)
def test_kernels_grid_cell_runs_and_promotes_on_the_cpu(tmp_path, default_store, cell):
    """One cell per kernel component, tiny signature, the real measure on
    CPU tensors (``kernel`` routes to the plain version): it promotes under
    this process's ``cpu:`` context, and the op then resolves the promoted
    settings."""
    before = rms_kernel.rmsnorm.launches
    c = tcampaign.Campaign([cell], tlaunch.build_measure(reps=2, device="cpu"), campaign_id="k",
                           journal_root=tmp_path / "j")
    r = c.run()[cell.cell_id]
    assert r.evaluations == 3 and r.gate["verdict"] in ("improved", "noise", "regressed")
    entry = default_store.resolve_entry(cell.context())
    assert (entry is not None) == r.promoted
    if r.promoted:
        assert entry["context"]["hardware"] == tstore.hardware_fingerprint()
        assert entry["context"]["hardware"].startswith("cpu:")
        assert entry["settings"] == r.best_config
        singleton = {"torch_flash_attention": attn_ops.attention_settings,
                     "torch_rmsnorm_kernel": rms_ops.rmsnorm_settings,
                     "torch_ssd_kernel": ssd_ops.ssd_settings}[cell.component]
        assert singleton.settings_for(cell.workload) == r.best_config
    assert rms_kernel.rmsnorm.launches == before        # CPU tensors reach no kernel
    assert tcampaign.Campaign([cell], tlaunch.build_measure(device="cpu"), campaign_id="k",
                              journal_root=tmp_path / "j").run()[cell.cell_id].resumed


def test_launch_main_runs_the_demo_grid(tmp_path, capsys):
    assert tlaunch.main(["--grid", "demo", "--budget", "4", "--quick", "--id", "cli",
                         "--store", str(tmp_path / "s"), "--journal-root", str(tmp_path / "j")]) == 0
    out = capsys.readouterr().out
    assert "4 cells (demo grid)" in out and "cells promoted into the config store" in out
    assert tlaunch.main(["--grid", "kernels", "--list", "--device", "cuda"]) == 0
    assert "pin={'impl': 'kernel'}" in capsys.readouterr().out


def test_kernels_grid_refuses_to_run_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tlaunch.run_grid("kernels", device="cuda")


def test_context_override_through_tuning(default_store):
    ov = tuning.parse_override("torch_rmsnorm_kernel@r16384d1536.block_rows=4")
    assert ov == {"torch_rmsnorm_kernel@r16384d1536": {"block_rows": 4}}
    tuning.apply_overrides(tuning.parse_override("torch_ssd_kernel@b1s256h48.chunk=32"))
    assert ssd_ops.ssd_settings.settings_for("b1s256h48")["chunk"] == 32
    assert ssd_ops.ssd_settings.settings_for("b2s512h48")["chunk"] == 64
    assert tuning.current_settings()["torch_ssd_kernel@b1s256h48"]["chunk"] == 32
    with pytest.raises(ValueError):
        tuning.parse_override("torch_ssd_kernel@b1s256h48.chunk=48")
    assert tuning.split_target("torch_ssd_kernel@b1s256h48") == ("torch_ssd_kernel", "b1s256h48")


def test_microbench_samples_on_the_cpu():
    import torch

    x = torch.ones(64)
    samples = microbench.time_samples_us(lambda t: t * 2, x, reps=4)
    assert len(samples) == 4 and all(s > 0 for s in samples)
    f = lambda t: t  # noqa: E731
    step = microbench.candidate("c", f, {"a": 1}, "w")
    assert step.fn is f and step.key == "autotune.c"
    assert microbench.candidate("c", lambda t: t, {"a": 1}, "w") is step
    assert microbench.candidate("c", lambda t: t, {"a": 2}, "w") is not step
    assert step(x) is x
