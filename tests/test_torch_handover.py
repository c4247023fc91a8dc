"""Serve programs outlive their server (``repro_torch.core.compilecache``'s
hand-over, taken by ``repro_torch.runtime.serve_loop.BatchedServer``).

The reference's servers share their compiled steps in process: a server
built after another of the same (config, capacity, batch) runs the steps
the first compiled.  The port's counterpart: a freed server hands its
graphs and the static buffers they are bound to over to the next server of
the same params and context, which starts from a new server's empty state.
Eager on the CPU (float32, reduced configs); the graph path's logic on the
stand-in graph of tests/test_torch_serve_steps.py, whose replay re-runs
the captured body.
"""
from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import compilecache
from repro_torch.core.compilecache import Graphs, clear_registry, step_counts
from repro_torch.models import model as M
from repro_torch.runtime import serve_loop
from repro_torch.runtime.serve_loop import BatchedServer
from repro_torch.tree import leaves

CAPACITY = 32
SETTINGS = {"max_batch": 3, "sync_interval": 3, "admission": 2, "prefill_chunk": 16}


def _params(name):
    cfg = get_config(name).reduced().validate()
    return M.init_params(cfg, torch.Generator().manual_seed(zlib.crc32(name.encode())),
                         device="cpu"), cfg


@pytest.fixture(scope="module")
def olmo():
    return _params("olmo-1b")


@pytest.fixture(autouse=True)
def empty_pool():
    clear_registry()
    yield
    clear_registry()


def _prompts(tag, n=7):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    return [rng.integers(2, 250, size=int(k)).astype(np.int32) for k in rng.integers(1, 20, n)]


def _server(params, cfg, mode="continuous", **settings):
    return BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode=mode, device="cpu",
                         settings={**(SETTINGS if mode == "continuous" else {"max_batch": 3}),
                                   **settings})


def _serve(srv, prompts, budget=6):
    for p in prompts:
        srv.submit(p)
    srv.run(max_new_tokens=budget)
    return {r.rid: list(r.tokens) for r in srv.results.values()}


def _fresh_streams(params, cfg, prompts, **kw):
    compilecache.drop_handed_over()
    out = _serve(_server(params, cfg, **kw), prompts)
    compilecache.drop_handed_over()
    return out


@pytest.mark.parametrize("mode", ["continuous", "gang"])
@pytest.mark.parametrize("name", ["olmo-1b", "olmoe-1b-7b", "seamless-m4t-medium"])
def test_a_handed_over_server_serves_a_fresh_servers_streams(name, mode):
    """The second server of one params and context takes the first one's
    graphs and buffers, starts from the empty state (every slot done, the
    registers, history and caches zero) and serves a new server's streams:
    for MoE too, where an idle slot's garbage competes for capacity, and
    for an encoder-decoder's cross caches."""
    params, cfg = _params(name)
    prompts = _prompts((name, mode))
    want = _fresh_streams(params, cfg, prompts, mode=mode)
    first = _server(params, cfg, mode)
    _serve(first, _prompts(("first", name, mode)))
    graphs, caches = first.graphs, first._caches
    assert any(bool((leaf != 0).any()) for leaf in leaves(caches))
    del first
    second = _server(params, cfg, mode)
    assert second.graphs is graphs and second._caches is caches
    st = second._st
    assert bool(st.done.all()) and not st.tok.any() and not st.pos.any()
    assert not st.hist.any() and not st.hist_row.any()
    assert all(not bool(leaf.any()) for leaf in leaves(caches))
    assert _serve(second, prompts) == want


def test_two_live_servers_never_share(olmo):
    params, cfg = olmo
    a = _server(params, cfg)
    _serve(a, _prompts("live-a"))
    b = _server(params, cfg)
    assert b.graphs is not a.graphs and b._st.tok is not a._st.tok
    _serve(b, _prompts("live-b"))
    assert b._caches is not a._caches
    assert compilecache.drop_handed_over() == 0


@pytest.mark.parametrize("change", ["max_batch", "eos_id", "capacity", "params"])
def test_another_context_or_model_takes_nothing(olmo, change):
    """A server differing in max_batch, eos_id, capacity or its params'
    identity (a copy of the tree, one leaf at another address) builds its
    own state; the finished one stays in the pool."""
    params, cfg = olmo
    first = _server(params, cfg)
    _serve(first, _prompts("ctx"))
    graphs = first.graphs
    del first
    kw = dict(capacity=CAPACITY, eos_id=-1, device="cpu", settings=dict(SETTINGS))
    p = params
    if change == "max_batch":
        kw["settings"]["max_batch"] = 2
    elif change == "eos_id":
        kw["eos_id"] = 1
    elif change == "capacity":
        kw["capacity"] = 2 * CAPACITY
    else:
        p = dict(params, embed=params["embed"].clone())
    assert BatchedServer(p, cfg, **kw).graphs is not graphs
    assert BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, device="cpu",
                         settings=dict(SETTINGS)).graphs is graphs


def test_the_scheduler_mode_is_not_part_of_the_context(olmo):
    """A gang server after a continuous one of the same context takes its
    state (each binds its own decode step in the shared graphs)."""
    params, cfg = olmo
    first = _server(params, cfg, max_batch=3)
    _serve(first, _prompts("mode"))
    graphs = first.graphs
    del first
    gang = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode="gang", device="cpu",
                         settings=dict(SETTINGS))
    assert gang.graphs is graphs
    prompts = _prompts("mode-gang")
    got = _serve(gang, prompts)
    del gang
    assert got == _fresh_streams(params, cfg, prompts, mode="gang", **SETTINGS)


@pytest.fixture
def replaying_capture(monkeypatch):
    """Graph mode on the CPU: warm-up runs the body, the capture records it,
    a replay runs it again (tests/test_torch_serve_steps.py's stand-in)."""
    class Replaying:
        def __init__(self, fn, args):
            self.fn, self.args = fn, args

        def replay(self):
            self.fn(*self.args)

    monkeypatch.setattr(compilecache, "_warm_up", lambda fn, args: fn(*args))
    monkeypatch.setattr(compilecache, "_capture", lambda fn, args, pool: Replaying(fn, args))
    monkeypatch.setattr(compilecache, "_new_pool", lambda: ("pool",))


@pytest.mark.parametrize("mode", ["continuous", "gang"])
def test_a_handed_over_program_is_replayed_not_captured(olmo, replaying_capture, mode):
    """Graph mode: the first server captures one prefill program per width
    class and its decode step; the second, on the same requests, captures
    nothing and replays every program (one host fetch per sync kept)."""
    params, cfg = olmo
    prompts = _prompts(("graph", mode))
    want = _fresh_streams(params, cfg, prompts, mode=mode)
    first = _server(params, cfg, mode)
    first.graphs = Graphs(capture=True)
    assert _serve(first, prompts) == want
    captured = dict(first.graphs.captures)
    assert captured["serve.prefill"] == len(first._admit_steps) > 1
    del first
    before = step_counts()
    fetches = []
    real = serve_loop._host_fetch
    serve_loop._host_fetch = lambda x: (fetches.append(1), real(x))[1]
    try:
        second = _server(params, cfg, mode)
        assert _serve(second, prompts) == want
    finally:
        serve_loop._host_fetch = real
    after = step_counts()
    assert second.graphs.captures == captured
    assert all(after[k]["captures"] == before[k]["captures"] for k in after)
    assert sum(after[k]["replays"] - before[k].get("replays", 0) for k in after) > 0
    if mode == "continuous":
        assert len(fetches) == second.decode_syncs


def test_the_pool_keeps_at_most_its_bound_and_frees_on_drop():
    for i in range(compilecache.HANDED_MAX + 2):
        compilecache.hand_over(("k", i), object())
    assert compilecache.take_over(("k", 0)) is None                # the oldest went first
    last = compilecache.take_over(("k", compilecache.HANDED_MAX + 1))
    assert last is not None and compilecache.take_over(("k", compilecache.HANDED_MAX + 1)) is None
    assert compilecache.drop_handed_over() == compilecache.HANDED_MAX - 1
    assert compilecache.drop_handed_over() == 0
