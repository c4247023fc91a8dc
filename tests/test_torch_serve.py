"""The port's continuous-batching server (``repro_torch.runtime.serve_loop``)
on the CPU, against its own contracts and against the reference server.

The contracts are the reference's (tests/test_serve_loop.py): the
continuous scheduler is a pure reordering of work, so every request's greedy
token stream is bit-identical to decoding it alone (gang mode at
``max_batch=1``); the host reads device values through ``_host_fetch`` once
per ``sync_interval`` decode steps and nowhere else; an EOS frees its slot
mid-flight; a non-windowed cache never wraps.

Parity: the reference initializes reduced olmo-1b in float32, the port loads
the same weights (``params_from_reference``), and both servers take the same
prompts, drawn with numpy from ``zlib.crc32`` seeds.  Their greedy tokens
must be equal.  The two packages sum in different orders (logits agree to
1e-4, tests/test_torch_model.py), so the only accepted difference is an
argmax whose top-2 logit gap is below that tolerance; the assertion message
shows the gap.
"""
import inspect
import math
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.runtime import traffic as jtraffic
from repro.runtime.serve_loop import BatchedServer as JServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models import model as M
from repro_torch.runtime import serve_loop, traffic
from repro_torch.runtime.serve_loop import BatchedServer

CAPACITY = 32
NEAR_TIE = 1e-4     # the f32 logit tolerance of tests/test_torch_model.py


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("olmo-1b").reduced().validate()
    cfg = get_config("olmo-1b").reduced().validate()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_reference(jax.device_get(jparams), cfg, device="cpu")
    return params, cfg, jparams, jcfg


def _prompts(tag, n, lo=3, hi=14):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    return [rng.integers(2, 250, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


def _serve(served, mode, settings, prompts, budget, eos_id=-1):
    params, cfg = served[:2]
    s = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=eos_id, mode=mode,
                      settings=settings, device="cpu")
    for p in prompts:
        s.submit(p)
    return s, s.run(max_new_tokens=budget)


def _streams(server):
    return {r.rid: list(r.tokens) for r in server.results.values()}


# ------------------------------------------------------- scheduler identity
def test_continuous_matches_sequential_gang(served):
    """Mixed widths across slots: continuous output == one-at-a-time gang."""
    prompts = _prompts("mixed", 5)
    ref, _ = _serve(served, "gang", {"max_batch": 1}, prompts, budget=6)
    srv, m = _serve(served, "continuous",
                    {"max_batch": 3, "admission": 2, "prefill_chunk": 16, "sync_interval": 2},
                    prompts, budget=6)
    assert _streams(srv) == _streams(ref)
    assert m["completed"] == 5 and m["queue_depth"] == 0 and m["live_slots"] == 0


def test_eos_frees_slot_midflight(served):
    """A sequence hitting EOS frees its slot before the batch drains, and a
    queued request decodes in the reused slot with correct state."""
    prompts = _prompts("eos", 4)
    free, _ = _serve(served, "gang", {"max_batch": 1}, prompts, budget=8)
    eos = _streams(free)[0][2]      # a token that really occurs early in request 0
    ref, _ = _serve(served, "gang", {"max_batch": 1}, prompts, budget=8, eos_id=eos)
    srv, m = _serve(served, "continuous", {"max_batch": 2, "admission": 1, "sync_interval": 1},
                    prompts, budget=8, eos_id=eos)
    assert _streams(srv) == _streams(ref)
    assert m["completed"] == 4
    assert srv.results[0].tokens[-1] == eos and len(srv.results[0].tokens) < 8
    assert sorted({r.slot for r in srv.results.values()}) == [0, 1]


@pytest.mark.parametrize("interval", [1, 3, 5])
def test_one_host_fetch_per_sync_interval(served, monkeypatch, interval):
    """Every device→host read goes through ``_host_fetch``, once per
    ``sync_interval`` decode steps, and the streams do not depend on it."""
    prompts = _prompts("sync", 6)
    calls = {"n": 0}
    real = serve_loop._host_fetch

    def counted(x):
        calls["n"] += 1
        return real(x)

    monkeypatch.setattr(serve_loop, "_host_fetch", counted)
    base = {"max_batch": 3, "admission": 3, "prefill_chunk": 64}
    srv, m = _serve(served, "continuous", dict(base, sync_interval=interval), prompts, budget=7)
    assert calls["n"] == m["decode_syncs"] == math.ceil(m["decode_steps"] / interval)
    monkeypatch.setattr(serve_loop, "_host_fetch", real)
    ref, _ = _serve(served, "gang", {"max_batch": 1}, prompts, budget=7)
    assert _streams(srv) == _streams(ref)


def test_hot_swap_mid_run_preserves_bit_identity(served):
    """Re-knobbing the scheduler between steps is still a pure reordering."""
    prompts = _prompts("swap", 6)
    ref, _ = _serve(served, "gang", {"max_batch": 1}, prompts, budget=8)
    params, cfg = served[:2]
    s = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode="continuous",
                      settings={"max_batch": 3, "admission": 2, "prefill_chunk": 16,
                                "sync_interval": 2}, device="cpu")
    for p in prompts:
        s.submit(p)
    s.begin_run(8)
    swaps = [{"sync_interval": 5}, {"admission": 1, "prefill_chunk": 8},
             {"sync_interval": 1, "admission": 4, "max_new_tokens": 8}]
    i = 0
    while s.queue or s.live_slots:
        s.apply_config(swaps[i % len(swaps)])
        i += 1
        s.step()
    m = s.finish_run()
    assert i >= 3
    assert _streams(s) == _streams(ref)
    assert m["completed"] == 6


# ------------------------------------------------------------- edge cases
def test_budget_clipped_so_full_cache_never_wraps(served):
    """Non-windowed cache: width + budget must stay <= capacity."""
    prompts = [np.arange(2, 2 + 14, dtype=np.int32)]   # width buckets to 16
    srv, _ = _serve(served, "continuous", {"max_batch": 2}, prompts, budget=10_000)
    assert len(srv.results[0].tokens) == CAPACITY - 16


def test_long_prompt_keeps_its_tail(served):
    """A prompt longer than capacity // 2 keeps its most recent tokens."""
    params, cfg = served[:2]
    s = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, settings={"max_batch": 1},
                      device="cpu")
    long = np.arange(2, 2 + 40, dtype=np.int32)
    width = s._width_of(len(long))
    toks = s._pad_prompts([serve_loop._Request(0, long, 0.0)], 1, width)
    assert width == CAPACITY // 2
    assert toks.tolist() == [long[-width:].tolist()]


def test_left_pad_and_pow2_widths(served):
    params, cfg = served[:2]
    s = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, settings={"max_batch": 2},
                      device="cpu")
    assert [s._width_of(n) for n in (1, 2, 3, 5, 8, 9, 16, 17, 100)] == \
        [2, 2, 4, 8, 8, 16, 16, 16, 16]
    toks = s._pad_prompts([serve_loop._Request(0, np.array([7, 8, 9], np.int32), 0.0)], 2, 8)
    assert toks.tolist() == [[0, 0, 0, 0, 0, 7, 8, 9], [0] * 8]


def test_empty_queue_run_is_a_noop(served):
    params, cfg = served[:2]
    m = BatchedServer(params, cfg, capacity=CAPACITY, device="cpu").run()
    assert m["completed"] == 0 and m["total_tokens"] == 0
    assert m["decode_steps"] == 0 and m["decode_syncs"] == 0


@pytest.mark.parametrize("mode", ["gang", "continuous"])
def test_run_metrics_cover_this_run_only(served, mode):
    params, cfg = served[:2]
    s = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode=mode,
                      settings={"max_batch": 2}, device="cpu")
    for p in _prompts("run1", 3):
        s.submit(p)
    m1 = s.run(max_new_tokens=4)
    for p in _prompts("run2", 2):
        s.submit(p)
    m2 = s.run(max_new_tokens=4)
    assert m1["completed"] == 3 and m2["completed"] == 2
    assert m2["total_tokens"] == 2 * 4
    assert len(s.results) == 5


def test_apply_config_rejects_shape_baked_knobs(served):
    params, cfg = served[:2]
    s = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, settings={"max_batch": 2},
                      device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        s.apply_config({"max_batch": 4})
    with pytest.raises(ValueError, match="bogus"):
        s.apply_config({"bogus": 1})
    s.apply_config({k: 3 for k in serve_loop.HOT_SWAP_KNOBS})
    got = s.current_config()
    assert all(got[k] == 3 for k in serve_loop.HOT_SWAP_KNOBS) and got["max_batch"] == 2


def test_rolling_window_reaches_the_emitter_and_resets(served):
    """``emitter`` is any object with ``.emit(dict)``: it receives one
    record per sync and the run's totals; ``last_window`` resets per run."""
    class Sink:
        def __init__(self):
            self.records = []

        def emit(self, rec):
            self.records.append(dict(rec))

    params, cfg = served[:2]
    sink = Sink()
    s = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, emitter=sink, device="cpu",
                      settings={"max_batch": 2, "admission": 1, "prefill_chunk": 8,
                                "sync_interval": 2})
    for p in _prompts("window", 4):
        s.submit(p)
    s.begin_run(6)
    assert s.last_window is None
    s.step()
    w1 = s.last_window
    assert w1["tokens_per_s"] > 0
    assert w1["queue_depth"] == float(len(s.queue)) and w1["live_slots"] == float(s.live_slots)
    s.drain()
    m = s.finish_run()
    assert m["completed"] == 4
    assert sink.records[-1]["tokens_per_s"] == pytest.approx(m["tokens_per_s"])
    assert len(sink.records) == m["decode_syncs"] + 1
    s.begin_run(6)
    assert s.last_window is None


def test_params_must_live_on_the_server_device(served):
    params, cfg = served[:2]
    with pytest.raises(ValueError, match="params live on"):
        BatchedServer(params, cfg, capacity=CAPACITY, device="meta")


def test_component_is_distinct_from_reference():
    from repro.core.registry import get_component as jget
    from repro_torch.core.registry import get_component

    meta = get_component("torch_serve_batching")
    ref = jget("serve_batching")
    assert meta.space.names == ref.space.names
    assert meta.space.defaults() == ref.space.defaults()
    assert serve_loop.HOT_SWAP_KNOBS == ("admission", "prefill_chunk", "sync_interval",
                                         "max_new_tokens")


# ------------------------------------------------------ against the reference
def test_traffic_generators_match_reference():
    for name, gen in traffic.SCENARIOS.items():
        # same options, same defaults: the port's copy adds no knob of its own
        assert inspect.signature(gen) == inspect.signature(jtraffic.SCENARIOS[name]), name
        a, b = gen(11, n=8), jtraffic.SCENARIOS[name](11, n=8)
        assert [x.at for x in a] == [x.at for x in b], name
        assert [x.budget for x in a] == [x.budget for x in b], name
        assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b)), name


def _top2_gap_at(served, prompt, width, stream, t):
    """The port's batch-1 logits along ``stream``: top-2 gap at step t."""
    params, cfg = served[:2]
    toks = np.zeros((1, width), np.int64)
    n = min(len(prompt), width)
    toks[0, -n:] = prompt[-n:]
    logits, caches, pos = M.prefill(params, cfg, torch.from_numpy(toks), CAPACITY)
    for tok in stream[:t]:
        logits, caches = M.decode_step(params, cfg, torch.tensor([tok]), caches, pos)
        pos += 1
    top = logits[0].topk(2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("mode,settings", [
    ("continuous", {"max_batch": 3, "admission": 2, "prefill_chunk": 16, "sync_interval": 2}),
    ("gang", {"max_batch": 1}),
])
def test_greedy_tokens_match_reference_server(served, mode, settings):
    params, cfg, jparams, jcfg = served
    prompts = _prompts(("parity", mode), 6)
    srv, _ = _serve(served, mode, settings, prompts, budget=6)
    ref = JServer(jparams, jcfg, capacity=CAPACITY, eos_id=-1, mode=mode, settings=settings)
    for p in prompts:
        ref.submit(p)
    ref.run(max_new_tokens=6)
    got, want = _streams(srv), _streams(ref)
    assert got.keys() == want.keys()
    for rid, stream in got.items():
        if stream == want[rid]:
            continue
        t = next(i for i, (x, y) in enumerate(zip(stream, want[rid])) if x != y)
        gap = _top2_gap_at(served, prompts[rid], srv._width_of(len(prompts[rid])), stream, t)
        assert gap < NEAR_TIE, (f"request {rid} diverges from the reference at step {t} "
                                f"with a top-2 logit gap of {gap:.3g}: not a near-tie")
