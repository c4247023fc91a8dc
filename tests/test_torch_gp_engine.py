"""The port's torch GP engine (``repro_torch.core.optimizers.engine``) held
against the reference's JAX engine and the numpy backend, on the CPU in
float64, as counterparts of ``tests/test_optimizer_engine.py``.

The reference engine imports ``jax.experimental.enable_x64``, which jax
0.9.0 no longer has.  The module fixture ``jengine`` sets it to
``jax.enable_x64`` for this file only, imports the engine, and on teardown
restores ``jax.experimental`` and drops the module again, so the reference's
own engine tests keep failing at import as they do on their own.

Tolerances: suggestions are compared exactly (the argmax of the same pool);
acquisition scores within 1e-8 absolute (the reference's numpy parity
tolerance); factors within 1e-10; fitted θ within 1e-8 relative and the NLL
at it within 1e-10 relative (the closed-form gradient agrees with
``jax.grad`` to rounding, measured ~1e-15).
"""
import importlib
import json
import sys

import jax
import jax.experimental
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # pragma: no cover - exercised in hypothesis-less CI
    given = None

from repro.core import tunable as jtunable
from repro.core.optimizers import BayesOpt as JBayesOpt
from repro.core.optimizers import gaussian_process as jgp
from repro_torch.core import optimizers as topt
from repro_torch.core import tunable as ttunable
from repro_torch.core.compilecache import step_counts
from repro_torch.core.optimizers import BayesOpt, make_optimizer
from repro_torch.core.optimizers import engine as te
from repro_torch.core.optimizers.bayesopt import dedup_rows
from repro_torch.core.optimizers.gaussian_process import GP, KERNELS
from torch_threads import one_thread

CPU = "cpu"
KERNEL_NAMES = ("rbf", "matern32", "matern52")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def jengine():
    """The reference's ``repro.core.optimizers.engine``, importable for this
    module only (see the module docstring)."""
    name = "repro.core.optimizers.engine"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
        mod = importlib.import_module(name)
        try:
            yield mod
        finally:
            sys.modules.pop(name, None)
            pkg = sys.modules["repro.core.optimizers"]
            if getattr(pkg, "engine", None) is mod:
                delattr(pkg, "engine")


@pytest.fixture
def cpu_defaults(monkeypatch):
    """Optimizer defaults that build torch BO on the CPU (restored after)."""
    monkeypatch.setattr(topt, "_DEFAULTS", {"backend": "numpy", "device": CPU})


def mixed_space(m):
    return m.TunableSpace([
        m.Int("n", 16, 4, 64),
        m.Categorical("mode", "a", ("a", "b", "c")),
        m.Float("w", 0.5, 0.0, 1.0),
    ])


def _objective(cfg):
    return abs(cfg["n"] - 32) * 0.1 + (0.0 if cfg["mode"] == "b" else 5.0) \
        + (cfg["w"] - 0.3) ** 2


def _seed_history(opts, seed, k=10):
    rng = np.random.default_rng(seed)
    space = opts[0].space
    for _ in range(k):
        cfg = space.sample(rng)
        for o in opts:
            o.tell(cfg, _objective(cfg))


# n_candidates (+ a quarter as local perturbations): the reference's tests use
# 1024; a quarter of it keeps these tests to seconds on a shared CPU and
# changes no contract.
POOL = 256


def _torch_bo(seed, **kw):
    kw.setdefault("device", CPU)
    kw.setdefault("n_candidates", POOL)
    return BayesOpt(mixed_space(ttunable), seed=seed, backend="torch", **kw)


def _jax(x):
    with jax.enable_x64():
        return jax.numpy.asarray(np.asarray(x, dtype=np.float64))


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


# ----------------------------------------------------------- parity contract
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_jax_numpy_identical_configs(jengine, seed):
    """Same seed, same history: the torch engine suggests the reference
    jax engine's and the numpy backend's configs, three asks deep."""
    j = JBayesOpt(mixed_space(jtunable), seed=seed, backend="jax", fit_hypers=False,
                  n_candidates=POOL)
    n = BayesOpt(mixed_space(ttunable), seed=seed, fit_hypers=False, n_candidates=POOL)
    t = _torch_bo(seed, fit_hypers=False)
    _seed_history([j], seed)
    _seed_history([n, t], seed)
    for _ in range(3):
        cj, cn, ct = j.ask(), n.ask(), t.ask()
        assert ct == cj == cn
        for o, c in ((j, cj), (n, cn), (t, ct)):
            o.tell(c, _objective(c))


@pytest.mark.parametrize("acq", ["ei", "ucb"])
def test_acquisition_scores_match_jax_and_numpy(jengine, acq):
    """One pool scored by the torch engine, the jax engine and the numpy GP."""
    from scipy.stats import norm

    space = mixed_space(ttunable)
    t = _torch_bo(5, fit_hypers=False, acquisition=acq)
    j = JBayesOpt(mixed_space(jtunable), seed=5, backend="jax", fit_hypers=False,
                  n_candidates=POOL)
    _seed_history([t], 5, k=12)
    _seed_history([j], 5, k=12)
    X = space.encode_batch([o.config for o in t.history])
    y = np.array([o.value for o in t.history])
    Xd, yd = dedup_rows(X, y)
    cand = np.random.default_rng(7).random((300, len(space)))

    mu, sd = GP(kernel="matern32", fit_hypers=False).fit(Xd, yd).predict(cand)
    if acq == "ucb":
        ref = -(mu - 2.0 * sd)
    else:
        imp = float(yd.min()) - mu
        z = imp / np.maximum(sd, 1e-12)
        ref = np.where(sd > 1e-12, imp * norm.cdf(z) + sd * norm.pdf(z), 0.0)
    idx, scores = t._engine_for().suggest(cand, acq, 2.0)
    jidx, jscores = j._engine_for().suggest(cand, acq, 2.0)
    assert scores.shape == (300,)
    np.testing.assert_allclose(scores, ref, atol=1e-8)
    np.testing.assert_allclose(scores, jscores, atol=1e-8)
    assert idx == jidx == int(np.argmax(ref))


# ------------------------------------------------- primitives against jax ===
def _buffers(seed, n, d, max_n):
    rng = np.random.default_rng(seed)
    X = np.zeros((max_n, d))
    X[:n] = rng.random((n, d))
    y = np.zeros(max_n)
    y[:n] = rng.standard_normal(n)
    mask = np.zeros(max_n)
    mask[:n] = 1.0
    return X, y, mask, rng


@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_full_chol_and_append_match_jax(jengine, kernel):
    """The factor of the masked kernel matrix and the rank-1 append (L, X, y
    and mask) equal the jax engine's on the same padded buffers."""
    X, y, mask, rng = _buffers(3, 20, 4, 32)
    theta = np.array([0.4, 1.3, 1e-3])
    fns = jengine._compiled(kernel)
    with jax.enable_x64():
        jL = np.asarray(fns["full_chol"](_jax(X), _jax(mask), _jax(theta)))
    tL = torch.zeros(32, 32, dtype=torch.float64)
    te._body("gp.full_chol", kernel)(_t(X), _t(mask), _t(theta), tL)
    np.testing.assert_allclose(tL.numpy(), jL, atol=1e-10)
    assert np.allclose(tL.numpy()[20:, 20:], np.eye(12)) and not tL.numpy()[20:, :20].any()

    x_new, y_new = rng.random(4), 0.25
    with jax.enable_x64():
        want = [np.asarray(a) for a in fns["append"](_jax(jL), _jax(X), _jax(y), _jax(mask),
                                                     _jax(x_new), y_new, _jax(theta))]
    got = [tL, _t(X), _t(y), _t(mask)]
    te._body("gp.append", kernel)(got[0], got[1], got[2], got[3],
                                  _t(np.append(x_new, y_new)), _t(theta))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-10)
    assert got[3].sum().item() == 21


@pytest.mark.parametrize("kernel", KERNEL_NAMES)
def test_fit_hypers_matches_jax(jengine, kernel):
    """Projected multi-start Adam: the fitted θ equals the jax engine's
    (``jax.grad`` of the NLL; here the closed-form gradient), and so does
    the NLL at it."""
    X, y, mask, _ = _buffers(11, 26, 3, 32)
    theta0s = np.log([[ls0, 1.0, 1e-4] for ls0 in te._LS_STARTS])
    with jax.enable_x64():
        jtheta = np.asarray(jengine._compiled(kernel)["fit_hypers"](
            _jax(X), _jax(mask), _jax(y), _jax(theta0s)))
    ttheta = torch.zeros(3, dtype=torch.float64)
    te._body("gp.fit", kernel)(_t(X), _t(mask), _t(y), _t(theta0s), ttheta)
    np.testing.assert_allclose(ttheta.numpy(), jtheta, rtol=1e-8)
    assert np.all(np.log(jtheta) >= np.array(te._THETA_LO) - 1e-12)
    assert np.all(np.log(jtheta) <= np.array(te._THETA_HI) + 1e-12)

    n, _, _, yn, _ = te._ystats(_t(y), _t(mask))
    d2 = te._sqdist(_t(X), _t(X))
    kfn = te._KERNELS[kernel]
    nll_t, _ = te._nll(torch.log(ttheta)[None], d2, _t(mask), yn, n, kfn, grad=False)
    nll_j, _ = te._nll(_t(np.log(jtheta))[None], d2, _t(mask), yn, n, kfn, grad=False)
    np.testing.assert_allclose(nll_t.numpy(), nll_j.numpy(), rtol=1e-10)


def test_engine_theta_matches_jax_with_fitting_on(jengine):
    """The whole ensure_ready path (refit on cadence, then refactor) gives
    the jax engine's θ and factor."""
    rng = np.random.default_rng(4)
    X, y = rng.random((30, 3)), rng.standard_normal(30)
    a, b = jengine.JaxGP(3), te.TorchGP(3, device=CPU)
    for i in range(30):
        a.observe(X[i], y[i])
        b.observe(X[i], y[i])
        if i in (4, 20):
            a.ensure_ready()
            b.ensure_ready()
    a.ensure_ready()
    b.ensure_ready()
    np.testing.assert_allclose(b.theta, a.theta, rtol=1e-8)
    np.testing.assert_allclose(b.L.numpy(), np.asarray(a._L), atol=1e-9)
    assert b.refactorizations == a.refactorizations


def test_a_failed_cholesky_reads_nan_and_the_nll_1e10():
    """A matrix that is not positive definite gives a NaN factor, as
    ``jnp.linalg.cholesky`` does; the NLL reads 1e10 and its gradient 0."""
    L = te._chol(torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64))
    assert torch.isnan(L).all()
    d2 = torch.zeros(2, 2, dtype=torch.float64)            # two equal rows
    mask = torch.ones(2, dtype=torch.float64)
    yn = torch.tensor([1.0, -1.0], dtype=torch.float64)
    th = torch.tensor([[0.0, 0.0, -300.0]], dtype=torch.float64)  # nv + jitter: 1e-8
    v, g = te._nll(th, d2, mask, yn, torch.tensor(2.0, dtype=torch.float64),
                   te._matern32, grad=True)
    assert torch.isfinite(v).all() and torch.isfinite(g).all()
    th_bad = torch.tensor([[0.0, 0.0, float("nan")]], dtype=torch.float64)
    v, g = te._nll(th_bad, d2, mask, yn, torch.tensor(2.0, dtype=torch.float64),
                   te._matern32, grad=True)
    assert v.item() == 1e10 and (g == 0).all()


# ------------------------------------------------- incremental Cholesky ====
def _check_incremental_matches_full(seed, n, kernel):
    rng = np.random.default_rng(seed)
    d = 3
    X = rng.random((n, d))
    y = rng.standard_normal(n)
    eng = te.TorchGP(d, kernel=kernel, fit_hypers=False, device=CPU)
    eng.observe(X[0], y[0])
    eng.ensure_ready()  # build the 1-row factor so later tells take the rank-1 path
    for i in range(1, n):
        eng.observe(X[i], y[i])
    eng.ensure_ready()
    ls, sv, nv = eng.theta
    K = sv * KERNELS[kernel](X, X, ls) + (nv + 1e-8) * np.eye(n)
    np.testing.assert_allclose(eng.L.numpy()[:n, :n], np.linalg.cholesky(K), atol=1e-8)


@pytest.mark.parametrize("seed,n,kernel", [(0, 12, "matern32"), (1, 16, "rbf"),
                                           (2, 30, "matern52"), (3, 40, "matern32")])
def test_incremental_cholesky_equals_full_deterministic(seed, n, kernel):
    _check_incremental_matches_full(seed, n, kernel)


if given is not None:

    @given(st.integers(0, 1000), st.integers(2, 24), st.sampled_from(list(KERNEL_NAMES)))
    @settings(max_examples=10, deadline=None)
    def test_incremental_cholesky_equals_full_property(seed, n, kernel):
        _check_incremental_matches_full(seed, n, kernel)


def test_the_kernels_equal_the_numpy_references():
    rng = np.random.default_rng(2)
    a, b = rng.random((7, 3)), rng.random((5, 3))
    for name in KERNEL_NAMES:
        k, _ = te._KERNELS[name](te._sqdist(_t(a), _t(b)), torch.tensor(0.37, dtype=torch.float64))
        np.testing.assert_allclose(k.numpy(), KERNELS[name](a, b, 0.37), rtol=1e-12)
        np.testing.assert_allclose(k.numpy(), jgp.KERNELS[name](a, b, 0.37), rtol=1e-12)


# ---------------------------------------------------------- buckets, programs
def test_buckets_grow_at_powers_of_two_only():
    assert [te.bucket_of(n) for n in (0, 1, 16, 17, 32, 33, 200)] == \
        [16, 16, 16, 32, 32, 64, 256]
    eng = te.TorchGP(2, fit_hypers=False, device=CPU)
    rng = np.random.default_rng(0)
    eng.observe(rng.random(2), 0.0)
    eng.ensure_ready()
    base = eng.refactorizations
    for _ in range(15):  # fill the first bucket: rank-1 only, no refactor
        eng.observe(rng.random(2), float(rng.standard_normal()))
    eng.ensure_ready()
    assert eng.max_n == 16 and eng.refactorizations == base
    eng.observe(rng.random(2), 0.5)  # crosses 16 -> 32
    eng.ensure_ready()
    assert eng.max_n == 32 and eng.refactorizations == base + 1


def test_programs_are_bound_per_bucket_never_per_observation():
    """40 tells and 40 asks over buckets 16/32/64: one bound step per key
    and bucket (and pool), each run once per call."""
    eng = te.TorchGP(3, device=CPU)
    rng = np.random.default_rng(5)
    before = step_counts()
    for i in range(40):
        eng.observe(rng.random(3), float(rng.standard_normal()))
        if i >= 3:
            eng.suggest(rng.random((300, 3)))
    per_key = {}
    for key, _, _ in eng.graphs.bound:
        per_key[key] = per_key.get(key, 0) + 1
    assert per_key == {"gp.append": 3, "gp.suggest": 3}
    assert {k[1] for k in eng._bound if k[0] == "gp.suggest"} == {16, 32, 64}
    for key in ("gp.full_chol", "gp.fit"):        # shared programs: keyed per bucket too
        assert {("matern32", 3, b) for b in (16, 32, 64)} <= {
            k[1] for k in te._SHARED_BUFFERS if k[0] == key}
    after = step_counts()
    runs = {k: after[k]["runs"] - before.get(k, {}).get("runs", 0) for k in after}
    assert runs["gp.suggest"] == 37
    assert runs["gp.append"] == 40 - 4 - 2     # tells past the first factor, less 2 growths
    assert runs["gp.full_chol"] == eng.refactorizations
    assert eng.graphs.captures == {} and eng.graphs.replays == {}   # the CPU runs eagerly


def test_a_tell_uploads_one_staged_row():
    """observe stages x and y in one buffer of d + 1 values and runs the
    bound append on the resident state (no re-upload)."""
    eng = te.TorchGP(2, fit_hypers=False, device=CPU)
    eng.observe(np.array([0.1, 0.2]), 1.0)
    eng.ensure_ready()
    X_ptr = eng.state()[1].data_ptr()
    eng.observe(np.array([0.3, 0.4]), 2.0)
    assert eng._staged["append"].tolist() == [0.3, 0.4, 2.0]
    assert eng.state()[1].data_ptr() == X_ptr and eng.state()[2].sum().item() == 2


# -------------------------------------------------------------- dedup ======
def test_duplicate_encodings_fold_keep_best_on_host_and_device():
    eng = te.TorchGP(2, fit_hypers=False, device=CPU)
    eng.observe(np.array([0.1, 0.2]), 5.0)
    eng.observe(np.array([0.3, 0.4]), 1.0)
    eng.ensure_ready()
    eng.observe(np.array([0.1, 0.2]), 3.0)   # better: folds in place
    eng.observe(np.array([0.3, 0.4]), 2.0)   # worse: kept out
    assert eng.n == 2
    np.testing.assert_array_equal(eng.y, [3.0, 1.0])
    np.testing.assert_array_equal(eng.state()[3].numpy()[:2], [3.0, 1.0])
    assert eng.state()[2].sum().item() == 2 and eng.refactorizations == 1


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_collapsed_categoricals_dont_blow_up(backend):
    """A pure-categorical space collapses every config onto <= 2 encodings;
    the GP sees the deduped rows, not a singular 30-row matrix."""
    space = ttunable.TunableSpace([ttunable.Categorical("flag", False, (False, True))])
    opt = BayesOpt(space, seed=0, backend=backend, n_init=4, device=CPU, n_candidates=POOL)
    rng = np.random.default_rng(0)
    for _ in range(30):
        cfg = space.sample(rng)
        opt.tell(cfg, 0.0 if cfg["flag"] else 1.0)
        cfg2 = opt.ask()
        assert cfg2["flag"] in (False, True)
    if backend == "torch":
        assert opt._engine.n <= 2  # every duplicate folded in place


# -------------------------------------------------------- batched ask ======
def test_batched_ask_matches_sequential():
    def build(seed):
        o = _torch_bo(seed)
        _seed_history([o], 100 + seed, k=8)
        return o

    A = [build(s) for s in range(3)]
    B = [build(s) for s in range(3)]
    for _ in range(2):
        seq = [o.ask() for o in A]
        bat = te.batched_ask(B)
        assert seq == bat
        for o, c in zip(A, seq):
            o.tell(c, _objective(c))
        for o, c in zip(B, bat):
            o.tell(c, _objective(c))


def test_batched_ask_mixed_group_falls_back():
    """Pre-init torch BO and non-torch optimizers ride along untouched."""
    torch_opt = _torch_bo(0)
    _seed_history([torch_opt], 0, k=8)
    young = _torch_bo(1)  # no history yet
    rs = make_optimizer("rs", mixed_space(ttunable), seed=2)
    ref = [_torch_bo(0), _torch_bo(1), make_optimizer("rs", mixed_space(ttunable), seed=2)]
    _seed_history([ref[0]], 0, k=8)
    assert te.BatchedBayesOpt([torch_opt, young, rs]).ask_all() == [o.ask() for o in ref]


def test_batched_ask_pads_the_session_axis_to_a_power_of_two():
    """Three ready sessions of one signature run as one program over four
    stacked slots; a second poll reuses it."""
    opts = [_torch_bo(s, fit_hypers=False) for s in range(3)]
    for o in opts:
        _seed_history([o], 7, k=8)
    before = step_counts().get("gp.suggest_batched", {"runs": 0})["runs"]
    te.batched_ask(opts)
    te.batched_ask(opts)
    assert step_counts()["gp.suggest_batched"]["runs"] - before == 2
    shapes = {tuple(bufs[0].shape) for k, bufs in te._SHARED_BUFFERS.items()
              if k[0] == "gp.suggest_batched"}
    assert (4, 16, 16) in shapes       # the stacked factors: 3 sessions padded to 4


# ------------------------------------------------ mux protocol equivalence =
def _mux_against_serial(acqs, budget=7):
    """bo_torch sessions on the hashtable (session i asks with ``acqs[i]``)
    driven through ``AgentMux.observe_batch`` and each alone: the mux's and
    the serial drives' (best value, best config) per instance, and the runs
    of the batched program in the mux's drive."""
    from repro_torch.core.agent import AgentCore, AgentMux, make_session
    from repro_torch.core.codegen import pack_telemetry
    from repro_torch.core.registry import get_component
    from repro_torch.core.smartcomponents import TunableHashTable, hashtable_workload

    meta = get_component("torch_hashtable")
    ids = range(len(acqs))

    def sessions():
        return [make_session(meta, "collisions", optimizer="bo_torch", budget=budget,
                             seed=20 + iid, instance_id=iid) for iid in ids]

    def set_acq(core):
        assert core.opt.backend == "torch" and core.opt.device == torch.device(CPU)
        core.opt.acquisition = acqs[core.session.instance_id]

    def measure(table, iid, settings):
        table.apply_and_rebuild(settings)
        return hashtable_workload(table, n_keys=400, seed=2 + iid % 2)

    solo = {}
    for s in sessions():
        core = AgentCore(s)
        set_acq(core)
        table = TunableHashTable()
        cmd = json.loads(core.start_command().decode())
        while not core.done:
            nxt = core.observe(pack_telemetry(meta, s.instance_id,
                                              measure(table, s.instance_id, cmd["settings"])))
            if nxt is not None:
                cmd = json.loads(nxt.decode())
        solo[s.instance_id] = (core.opt.best.value, core.opt.best.config)

    mux = AgentMux(sessions())
    for core in mux.cores.values():
        set_acq(core)
    tables = {iid: TunableHashTable() for iid in ids}
    pending = {}
    for cmd in mux.start_commands():
        msg = json.loads(cmd.decode())
        pending[msg["instance"]] = msg["settings"]
    before = step_counts().get("gp.suggest_batched", {"runs": 0})["runs"]
    for _ in range(100):
        if mux.done:
            break
        payloads = [pack_telemetry(meta, iid, measure(tables[iid], iid, pending.pop(iid)))
                    for iid in ids if iid in pending]
        for out in mux.observe_batch(payloads):
            msg = json.loads(out.decode())
            if msg["type"] == "config_update":
                pending[msg["instance"]] = msg["settings"]
    assert mux.done
    muxed = {}
    for (_, iid), core in mux.cores.items():
        assert core.evaluations == budget
        muxed[iid] = (core.opt.best.value, core.opt.best.config)
    return muxed, solo, step_counts()["gp.suggest_batched"]["runs"] - before


@pytest.mark.parametrize("acqs", [("ei", "ei"), ("ei", "ucb", "ei", "ucb")])
def test_mux_observe_batch_with_torch_bo_matches_serial_drive(cpu_defaults, acqs):
    """bo_torch sessions through observe_batch reach the same best values
    and configs as their single-session serial twins (deterministic
    objective).  Two EI and two UCB sessions of one shape class make two
    batched groups whose programs differ only in the acquisition."""
    muxed, solo, batched_runs = _mux_against_serial(list(acqs))
    assert batched_runs > 0                                   # the batched program ran
    assert muxed == solo


def test_two_kernels_of_one_shape_class_in_one_process(jengine, cpu_defaults):
    """bo_torch (matern32) and bo_torch_rbf at the same d and bucket, hypers
    fitted, in one process: each suggests what the reference's jax engine
    of its kernel suggests, three asks deep."""
    for name, kernel in (("bo_torch", "matern32"), ("bo_torch_rbf", "rbf"),
                         ("bo_torch", "matern32")):
        t = make_optimizer(name, mixed_space(ttunable), seed=3, n_candidates=POOL)
        j = JBayesOpt(mixed_space(jtunable), seed=3, kernel=kernel, backend="jax",
                      n_candidates=POOL)
        assert t.kernel == kernel and t.fit_hypers
        _seed_history([t], 3, k=12)
        _seed_history([j], 3, k=12)
        for _ in range(3):
            ct, cj = t.ask(), j.ask()
            assert ct == cj, (name, ct, cj)
            t.tell(ct, _objective(ct))
            j.tell(cj, _objective(cj))
        np.testing.assert_allclose(t._engine.theta, j._engine.theta, rtol=1e-8)


def test_one_engine_asked_ei_then_ucb_matches_a_fresh_engine():
    """The acquisition and β are constants of the suggest program: one
    engine asked with EI, then UCB at β 2 and 3, scores each as an engine
    asked only that way does."""
    rng = np.random.default_rng(9)
    X, y = rng.random((12, 3)), rng.standard_normal(12)
    cand = rng.random((300, 3))

    def engine():
        eng = te.TorchGP(3, fit_hypers=False, device=CPU)
        for xi, yi in zip(X, y):
            eng.observe(xi, yi)
        return eng

    shared = engine()
    for acq, beta in (("ei", 2.0), ("ucb", 2.0), ("ucb", 3.0), ("ei", 2.0)):
        idx, scores = shared.suggest(cand, acq, beta)
        ref_idx, ref = engine().suggest(cand, acq, beta)
        np.testing.assert_array_equal(scores, ref)
        assert idx == ref_idx
    assert len({k for k in shared._bound if k[0] == "gp.suggest"}) == 3


# ----------------------------------------------------------- warm start ====
def test_inject_prior_counts_toward_init_and_replays_incumbent():
    """The reference's ``test_inject_prior_counts_toward_init_and_replays_incumbent``
    run against the port's numpy and torch backends."""
    space = ttunable.TunableSpace([ttunable.Float("x", 0.5, 0.0, 1.0),
                                   ttunable.Float("y", 0.5, 0.0, 1.0)])
    prior = [({"x": 0.3, "y": 0.4}, 5.0), ({"x": 0.8, "y": 0.9}, 1.0)]
    for backend in ("numpy", "torch"):
        opt = BayesOpt(space, seed=0, backend=backend, fit_hypers=False, n_init=2, device=CPU)
        assert opt.inject_prior(prior) == 2
        first = opt.ask()
        assert first == {"x": 0.8, "y": 0.9}  # incumbent replay: best prior
        opt.tell(first, 2.0)
        assert opt.model_ready
        nxt = opt.ask()  # model-phase ask (priors filled the init quota)
        assert set(nxt) == {"x", "y"}
        # best is a measured-here fact: the lower prior value never leaks out
        assert opt.best.value == 2.0 and opt.best.config == first
        if backend == "torch":
            # the replayed incumbent folds into its prior row
            assert opt._engine.n == 2 and opt._engine.refactorizations == 1


def test_inject_prior_backend_parity():
    """The reference's ``test_inject_prior_backend_parity`` against the port:
    warm-started numpy and torch backends ask for ask identical at fixed
    hyperparameters."""
    space = ttunable.TunableSpace([ttunable.Float("x", 0.5, 0.0, 1.0),
                                   ttunable.Float("y", 0.5, 0.0, 1.0)])
    rng = np.random.default_rng(11)
    prior = [({"x": float(a), "y": float(b)}, float(v))
             for a, b, v in zip(rng.random(6), rng.random(6), rng.random(6))]

    def drive(backend):
        opt = BayesOpt(space, seed=4, backend=backend, fit_hypers=False, n_init=5, device=CPU)
        opt.inject_prior(prior)
        asks = []
        for _ in range(4):
            cfg = opt.ask()
            asks.append(cfg)
            opt.tell(cfg, float((cfg["x"] - 0.6) ** 2 + (cfg["y"] - 0.2) ** 2))
        return asks

    a, b = drive("numpy"), drive("torch")
    for ca, cb in zip(a, b):
        assert ca == pytest.approx(cb)


def test_seed_observations_uploads_once_and_folds_duplicates(jengine):
    """Bulk priors land in the host buffers (one growth to fit them all),
    duplicates fold keep-best, and the next ensure_ready refactors once;
    the factor equals the jax engine's after the same seeding."""
    rng = np.random.default_rng(8)
    X = rng.random((20, 3))
    X[5] = X[2]
    y = rng.standard_normal(20)
    a, b = jengine.JaxGP(3, fit_hypers=False), te.TorchGP(3, fit_hypers=False, device=CPU)
    assert a.seed_observations(X, y) == b.seed_observations(X, y) == 19
    assert b.max_n == 32 and b.y[2] == min(y[2], y[5])
    a.ensure_ready()
    b.ensure_ready()
    assert b.refactorizations == 1
    np.testing.assert_allclose(b.L.numpy(), np.asarray(a._L), atol=1e-10)
    with pytest.raises(ValueError):
        b.seed_observations(X[:, :2], y)


def test_campaign_warm_start_reaches_seed_observations(cpu_defaults, tmp_path, monkeypatch):
    """A warm-started campaign cell with torch BO seeds its engine through
    inject_prior → seed_observations."""
    from repro_torch.core.campaign import Campaign, CampaignCell
    from repro_torch.core.configstore import ConfigStore
    from repro_torch.core.registry import get_component

    space = get_component("torch_hashtable").space

    def measure(cell, settings):
        x = space.encode(space.validate(settings))
        v = float(np.sum((x - 0.4) ** 2)) * 1000.0
        return {"time_us": v, "collisions": int(v), "memory_bytes": 1, "load_factor_ppm": 1}

    seeded = []
    real = te.TorchGP.seed_observations

    def spy(self, X, y):
        seeded.append(len(y))
        return real(self, X, y)

    monkeypatch.setattr(te.TorchGP, "seed_observations", spy)
    topt.set_optimizer_defaults(backend="torch")
    store = ConfigStore(str(tmp_path / "store"))
    Campaign([CampaignCell("torch_hashtable", "s128", "time_us", budget=6, seed=1)], measure,
             campaign_id="src", store=store, journal_root=str(tmp_path)).run()
    res = Campaign([CampaignCell("torch_hashtable", "s256", "time_us", budget=6, seed=2)],
                   measure, campaign_id="dst", store=store, journal_root=str(tmp_path),
                   warm_start=True).run()
    assert res["torch_hashtable@s256"].warm_start and seeded and seeded[-1] >= 1


# ------------------------------------------------------------ no fallback ==
def test_a_torch_optimizer_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space = mixed_space(ttunable)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.TorchGP(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BayesOpt(space, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_optimizer("bo_torch", space)
    assert BayesOpt(space).backend == "numpy"       # the default builds no engine


def test_names_and_defaults_select_the_torch_engine(cpu_defaults):
    from repro_torch.launch import tuning

    space = mixed_space(ttunable)
    for name, kernel in (("bo_torch", "matern32"), ("bo_torch_matern32", "matern32"),
                         ("bo_torch_rbf", "rbf")):
        opt = make_optimizer(name, space)
        assert (opt.backend, opt.kernel, opt.device) == ("torch", kernel, torch.device(CPU))
    for name in ("bo_jax", "bo_jax_rbf"):
        with pytest.raises(ValueError, match="bo_torch"):
            make_optimizer(name, space)
    with pytest.raises(ValueError, match="torch"):
        topt.set_optimizer_defaults(backend="jax")
    assert make_optimizer("bo", space).backend == "numpy"
    over = tuning.parse_override("optimizer.backend=torch")
    assert over == {"optimizer": {"backend": "torch"}}
    tuning.apply_overrides(over)
    tuning.apply_overrides(tuning.parse_override("optimizer.device=cpu"))
    assert topt.optimizer_defaults() == {"backend": "torch", "device": CPU}
    assert make_optimizer("bo", space).backend == "torch"
    assert make_optimizer("bo_rbf", space).kernel == "rbf"
    with pytest.raises(ValueError):
        tuning.parse_override("optimizer.backend=jax")


def test_argmax_takes_the_first_of_equal_scores():
    """The pool padding repeats the last row and EI is exactly 0 where
    sd <= 1e-12: argmax must take the first occurrence."""
    s = torch.tensor([0.0, 0.5, 0.5, 0.0, 0.5], dtype=torch.float64)
    assert torch.argmax(s).item() == 1
    assert torch.argmax(torch.zeros(2, 300, dtype=torch.float64), dim=-1).tolist() == [0, 0]
    assert te._pad_pool(np.arange(6.0).reshape(3, 2)).shape == (256, 2)
