"""The server's compiled steps on static buffers (``repro_torch.runtime.
serve_loop`` over ``repro_torch.core.compilecache``), run eagerly on the CPU
in float32, against the reference's server and against their own
contracts.

Parity: the reference initializes reduced olmo-1b and mamba2-780m in
float32, the port loads the same weights (``params_from_reference``), and
both servers take the same prompts, drawn with numpy from ``zlib.crc32``
seeds.  Their greedy tokens must be equal at every ``sync_interval``.  The
two packages sum in different orders (logits agree to 1e-4,
tests/test_torch_model.py), so the only accepted difference is an argmax
whose top-2 logit gap is below that tolerance; the message shows the gap.
On the CPU the port's hybrid forward rounds by batch (ROADMAP C), so
reduced hymba-1.5b is held continuous against gang, both at ``max_batch``
1.

The step registry's graph path needs a card; here its own logic runs on
the stand-in graph of tests/test_torch_compilecache.py, whose replay
re-runs the captured body, so a whole server can run its graph path on
the CPU (tests/test_torch_kernel_card.py runs the real one).
"""
from __future__ import annotations

import math
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.runtime.serve_loop import BatchedServer as JServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core import compilecache
from repro_torch.core.compilecache import Graphs, cache_counters, clear_registry, step_counts
from repro_torch.models import model as M
from repro_torch.runtime import serve_loop
from repro_torch.runtime.serve_loop import BatchedServer

CAPACITY = 32
NEAR_TIE = 1e-4     # the f32 logit tolerance of tests/test_torch_model.py


def _load(name):
    jcfg = jget_config(name).reduced().validate()
    cfg = get_config(name).reduced().validate()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return params_from_reference(jax.device_get(jparams), cfg, device="cpu"), cfg, jparams, jcfg


@pytest.fixture(scope="module")
def olmo():
    return _load("olmo-1b")


@pytest.fixture(scope="module")
def mamba():
    return _load("mamba2-780m")


@pytest.fixture(scope="module", params=["olmo-1b", "mamba2-780m"])
def pair(request, olmo, mamba):
    return {"olmo-1b": olmo, "mamba2-780m": mamba}[request.param]


def _prompts(tag, n, lo=1, hi=14):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    return [rng.integers(2, 250, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


def _streams(server):
    return {r.rid: list(r.tokens) for r in server.results.values()}


def _server(params, cfg, mode="continuous", eos_id=-1, **settings):
    return BatchedServer(params, cfg, capacity=CAPACITY, eos_id=eos_id, mode=mode,
                         settings=settings, device="cpu")


def _serve(srv, prompts, budget):
    for p in prompts:
        srv.submit(p)
    srv.run(max_new_tokens=budget)
    return _streams(srv)


def _top2_gap_at(params, cfg, prompt, width, stream, t):
    toks = np.zeros((1, width), np.int64)
    n = min(len(prompt), width)
    toks[0, -n:] = prompt[-n:]
    logits, caches, pos = M.prefill(params, cfg, torch.from_numpy(toks), CAPACITY)
    for tok in stream[:t]:
        logits, caches = M.decode_step(params, cfg, torch.tensor([tok]), caches, pos)
        pos += 1
    top = logits[0].topk(2).values
    return float(top[0] - top[1])


# -------------------------------------------------------- against the reference
@pytest.mark.parametrize("interval", [1, 4, 16])
def test_streams_match_reference_server_and_fetch_once_per_interval(pair, monkeypatch, interval):
    """The static-buffer steps give the reference server's greedy tokens, and
    ``_host_fetch`` runs once per ``sync_interval`` decode steps, each fetch
    carrying its interval's rows."""
    params, cfg, jparams, jcfg = pair
    settings = {"max_batch": 3, "admission": 2, "prefill_chunk": 16, "sync_interval": interval}
    prompts = _prompts(("steps", cfg.name, interval), 6)
    rows = []
    real = serve_loop._host_fetch
    monkeypatch.setattr(serve_loop, "_host_fetch", lambda x: (rows.append(x.shape[0]), real(x))[1])
    srv = _server(params, cfg, **settings)
    got = _serve(srv, prompts, budget=12)
    monkeypatch.setattr(serve_loop, "_host_fetch", real)
    assert len(rows) == srv.decode_syncs == math.ceil(srv.decode_steps / interval)
    assert rows == [interval] * len(rows) and sum(rows) == srv.decode_steps

    ref = JServer(jparams, jcfg, capacity=CAPACITY, eos_id=-1, mode="continuous",
                  settings=settings)
    for p in prompts:
        ref.submit(p)
    ref.run(max_new_tokens=12)
    want = _streams(ref)
    assert got.keys() == want.keys() and all(len(s) == 12 for s in got.values())
    for rid, stream in got.items():
        if stream == want[rid]:
            continue
        t = next(i for i, (x, y) in enumerate(zip(stream, want[rid])) if x != y)
        gap = _top2_gap_at(params, cfg, prompts[rid], srv._width_of(len(prompts[rid])), stream, t)
        assert gap < NEAR_TIE, (f"request {rid} diverges from the reference at step {t} "
                                f"with a top-2 logit gap of {gap:.3g}: not a near-tie")


def test_hybrid_continuous_equals_gang_at_batch_one():
    cfg = get_config("hymba-1.5b").reduced().validate()
    params = M.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    prompts = _prompts(("hybrid-steps",), 4)
    cont = _serve(_server(params, cfg, max_batch=1, sync_interval=4), prompts, budget=6)
    gang = _serve(_server(params, cfg, mode="gang", max_batch=1), prompts, budget=6)
    assert cont == gang


# ------------------------------------------------------------- the step bodies
def test_each_step_input_reaches_the_sync(olmo, monkeypatch):
    """A sync reads every decode step's input token, not the last step's
    ``sync_interval`` times: the static ``tok`` is overwritten in place by
    each step, so the history buffer must hold each step's value."""
    params, cfg = olmo[:2]
    prompts = _prompts(("history",), 2, lo=4, hi=9)
    fetched = []
    real = serve_loop._host_fetch
    monkeypatch.setattr(serve_loop, "_host_fetch", lambda x: fetched.append(real(x)) or fetched[-1])
    srv = _server(params, cfg, max_batch=2, sync_interval=8)
    got = _serve(srv, prompts, budget=8)
    monkeypatch.setattr(serve_loop, "_host_fetch", real)
    one = _serve(_server(params, cfg, max_batch=2, sync_interval=1), prompts, budget=8)
    assert got == one
    first = fetched[0]
    assert first.shape == (8, 2)
    assert len(set(got[0])) > 1                         # a stream the aliasing would change
    assert [first[:, srv.results[rid].slot].tolist() for rid in (0, 1)] == [got[0], got[1]]


def test_decode_updates_the_ssm_state_in_place(mamba):
    """Every cache leaf keeps its storage across a decode step (a captured
    step reads and writes the same buffers), and its new values are the
    functional update's."""
    params, cfg = mamba[:2]
    toks = torch.from_numpy(np.random.default_rng(1).integers(2, 250, (2, 6)))
    _, caches, pos = M.prefill(params, cfg, toks, CAPACITY)
    ptrs = [(c["ssm"]["conv"].data_ptr(), c["ssm"]["ssd"].data_ptr()) for c in caches]
    before = [{k: v.clone() for k, v in c["ssm"].items()} for c in caches]
    tok = torch.tensor([5, 7])
    _, out = M.decode_step(params, cfg, tok, caches, pos)
    assert out is caches
    assert [(c["ssm"]["conv"].data_ptr(), c["ssm"]["ssd"].data_ptr()) for c in caches] == ptrs
    # the first layer's update, recomputed from the saved state
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.ssm import apply_ssm_decode

    state = {k: v.clone() for k, v in before[0].items()}
    xn = apply_norm(params["blocks"][0]["ln1"], params["embed"][tok[:, None]], cfg)
    apply_ssm_decode(params["blocks"][0]["ssm"], xn, state, cfg)
    for k in ("conv", "ssd"):
        torch.testing.assert_close(caches[0]["ssm"][k], state[k], rtol=0, atol=0)
        assert not torch.equal(caches[0]["ssm"][k], before[0][k])


@pytest.mark.parametrize("name", ["olmo-1b", "hymba-1.5b"])
def test_install_slot_equals_merge_slot_and_the_three_writes(name):
    cfg = get_config(name).reduced().validate()
    params = M.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    axes = M.cache_batch_axes(cfg, 4, CAPACITY)
    gen = torch.Generator().manual_seed(3)
    big = [{k: (torch.randn(v.shape, generator=gen).to(v.dtype) if not isinstance(v, dict) else
                {kk: torch.randn(vv.shape, generator=gen).to(vv.dtype) for kk, vv in v.items()})
            for k, v in layer.items()} for layer in M.init_cache(cfg, 4, CAPACITY, device="cpu")]
    clone = [{k: (v.clone() if not isinstance(v, dict) else {kk: vv.clone() for kk, vv in v.items()})
              for k, v in layer.items()} for layer in big]
    toks = torch.from_numpy(np.random.default_rng(4).integers(2, 250, (1, 8)))
    logits, small, width = M.prefill(params, cfg, toks, CAPACITY)
    tok, pos, done = torch.zeros(4, dtype=torch.long), torch.arange(4), torch.ones(4, dtype=bool)
    ids = [id(leaf) for layer in big for leaf in layer.values()]

    M.install_slot(big, small, torch.tensor([2]), tok, pos, done, logits, width, batch_axes=axes)
    M.merge_slot(clone, small, 2, axes)
    for b, c in zip(big, clone):
        for k in b:
            for x, y in ([(b[k], c[k])] if not isinstance(b[k], dict) else
                         [(b[k][kk], c[k][kk]) for kk in b[k]]):
                torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert [id(leaf) for layer in big for leaf in layer.values()] == ids
    assert tok.tolist() == [0, 0, int(torch.argmax(logits[0])), 0]
    assert pos.tolist() == [0, 1, width, 3] and done.tolist() == [True, True, False, True]


def test_step_graph_raises_on_the_cpu(olmo):
    params, cfg = olmo[:2]
    with pytest.raises(ValueError, match="graph"):
        BatchedServer(params, cfg, capacity=CAPACITY, device="cpu", step="graph")
    with pytest.raises(ValueError, match="unknown step"):
        BatchedServer(params, cfg, capacity=CAPACITY, device="cpu", step="jit")
    assert BatchedServer(params, cfg, capacity=CAPACITY, device="cpu").step_mode == "eager"
    assert serve_loop.resolve_step(None, torch.device("cuda")) == "graph"
    assert serve_loop.resolve_step("eager", torch.device("cuda")) == "eager"


def test_sync_interval_is_bounded_by_the_history(olmo):
    params, cfg = olmo[:2]
    with pytest.raises(ValueError, match="sync_interval"):
        _server(params, cfg, sync_interval=serve_loop.HISTORY + 1)
    srv = _server(params, cfg, sync_interval=serve_loop.HISTORY)
    with pytest.raises(ValueError, match="sync_interval"):
        srv.apply_config({"sync_interval": serve_loop.HISTORY + 1})


def test_the_four_sites_are_the_references_keys_and_contexts(olmo):
    params, cfg = olmo[:2]
    clear_registry()
    try:
        srv = _server(params, cfg, max_batch=3)
        sig = compilecache.config_signature(cfg)
        sites = {s.key: s.context for s in (srv._prefill_step, srv._install_step,
                                             srv._gang_step, srv._fused_step)}
        assert sites == {
            "serve.prefill": (sig, "dense_c32", CAPACITY),
            "serve.install_slot": (sig, "dense_c32", CAPACITY, 3),
            "serve.decode_step": (sig, "dense_c32", CAPACITY, 3),
            "serve.decode_fused": (sig, "dense_c32", CAPACITY, 3, -1),
        }
        assert cache_counters()["misses"] == 4
    finally:
        clear_registry()


# ------------------------------------------------ the graph path's own logic
@pytest.fixture
def replaying_capture(monkeypatch):
    """Graph mode on the CPU: warm-up runs the body, the capture records it,
    a replay runs it again (the stand-in of a replay)."""
    class Replaying:
        def __init__(self, fn, args):
            self.fn, self.args = fn, args

        def replay(self):
            self.fn(*self.args)

    monkeypatch.setattr(compilecache, "_warm_up", lambda fn, args: fn(*args))
    monkeypatch.setattr(compilecache, "_capture", lambda fn, args, pool: Replaying(fn, args))
    monkeypatch.setattr(compilecache, "_new_pool", lambda: ("pool",))
    clear_registry()
    yield
    clear_registry()


def _graph_server(params, cfg, **settings):
    srv = _server(params, cfg, **settings)
    srv.graphs = Graphs(capture=True)       # the card's path on the stand-in graph
    return srv


@pytest.mark.parametrize("mode", ["continuous", "gang"])
def test_two_live_servers_share_steps_but_capture_their_own_graphs(olmo, replaying_capture, mode):
    """The registry's steps are shared (hits), the graphs never: each live
    server captures its own, on its own buffers, and both serve the eager
    path's streams.  Hot swaps need no recapture."""
    params, cfg = olmo[:2]
    prompts = _prompts(("two", mode), 5)
    settings = {"max_batch": 2, "sync_interval": 3} if mode == "continuous" else {"max_batch": 2}
    eager = _serve(_server(params, cfg, mode=mode, **settings), prompts, budget=6)
    counts0 = cache_counters()
    a = _graph_server(params, cfg, mode=mode, **settings)
    b = _graph_server(params, cfg, mode=mode, **settings)
    assert a._fused_step is b._fused_step and a._prefill_step is b._prefill_step
    assert cache_counters()["hits"] - counts0["hits"] == 8
    for p in prompts:
        a.submit(p)
        b.submit(p)
    a.begin_run(6)
    b.begin_run(6)
    while a.queue or a.live_slots or b.queue or b.live_slots:     # interleaved
        for srv in (a, b):
            if mode == "gang":
                srv._run_gang()
            elif srv.queue or srv.live_slots:
                srv.step()
                srv.apply_config({"sync_interval": 1 + srv.decode_syncs % 4})
    assert _streams(a) == _streams(b) == eager
    decode = "serve.decode_fused" if mode == "continuous" else "serve.decode_step"
    for srv in (a, b):
        widths = {k[1] for k in srv._admit_steps}
        assert srv.graphs.captures == {"serve.prefill": len(widths), decode: 1}
        assert srv.graphs.replays.get("serve.prefill", 0) == srv.prefill_calls - len(widths)
    assert {id(x) for x in a.graphs.bound.values()}.isdisjoint(
        {id(x) for x in b.graphs.bound.values()})
    assert step_counts()["serve.prefill"]["captures"] == 2 * len(
        {k[1] for k in a._admit_steps})


def test_a_failed_capture_stops_the_server(olmo, replaying_capture, monkeypatch):
    params, cfg = olmo[:2]

    def broken(fn, args, pool):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(compilecache, "_capture", broken)
    srv = _graph_server(params, cfg, max_batch=2)
    srv.submit(_prompts(("broken",), 1)[0])
    with pytest.raises(RuntimeError, match="capture failed"):
        srv.run(max_new_tokens=4)
    with pytest.raises(RuntimeError, match="never falls back"):
        srv._admit_steps[next(iter(srv._admit_steps))]()


def test_a_served_server_is_freed_by_reference_counting(olmo, replaying_capture):
    """Nothing the server builds refers back to it, so it is freed the
    moment it goes (the serving grid and the serve benchmark build dozens of
    servers a run); its graphs, caches and buffers are handed over to the
    next server of its model and context, and freed the moment the
    hand-over pool drops them."""
    import gc
    import weakref

    params, cfg = olmo[:2]
    collecting = gc.isenabled()
    gc.disable()
    try:
        srv = _graph_server(params, cfg, max_batch=2, sync_interval=2)
        _serve(srv, _prompts(("freed",), 3), budget=4)
        refs = [weakref.ref(x) for x in (srv, srv.graphs, srv._caches[0]["k"], srv._hist)]
        del srv
        assert refs[0]() is None and all(r() is not None for r in refs[1:])
        assert compilecache.drop_handed_over() == 1
        assert [r() for r in refs] == [None] * 4
    finally:
        if collecting:
            gc.enable()
