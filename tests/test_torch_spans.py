"""The span recorder (``repro_torch.core.telemetry.span``) and the spans and
stamps of the server (``runtime/serve_loop.py``) and of the train step
(``runtime/steps.py``), on reduced OLMo-1B in float32 on the CPU.

Tracing is off unless a profiler records or ``set_tracing(True)`` was
called: then a span is one flag check and nothing is entered or kept.  The
server's counts are held to sums worked out by hand from the prompt
lengths; its request stamps to the fetch stamps of its ``serve.sync``
spans.  The one ``cuda``-marked test holds the train spans' device times
to CUDA events around the whole step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import telemetry
from repro_torch.core.compilecache import clear_registry
from repro_torch.models import model as M
from repro_torch.runtime.serve_loop import BatchedServer
from repro_torch.runtime.steps import make_train_step

CAPACITY = 32
SERVE_NAMES = ("serve.admit", "serve.decode", "serve.sync")


@pytest.fixture(scope="module")
def olmo():
    cfg = get_config("olmo-1b").reduced().validate()
    return M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg


@pytest.fixture(autouse=True)
def _no_tracing():
    """Every test starts and ends with tracing off and an empty store."""
    telemetry.set_tracing(False)
    telemetry.clear_spans()
    clear_registry()
    yield
    telemetry.set_tracing(False)
    telemetry.clear_spans()
    clear_registry()


def _server(olmo, mode="continuous", **settings):
    params, cfg = olmo
    s = {"max_batch": 4, "admission": 4, "prefill_chunk": 64, "sync_interval": 4,
         "max_new_tokens": 6, **settings}
    return BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode=mode, settings=s,
                         device="cpu")


def _prompts(lengths):
    return [np.arange(2, 2 + n, dtype=np.int32) for n in lengths]


def _train_state(cfg, params):
    from repro_torch.optim.adamw import adamw_init

    step = torch.zeros((), dtype=torch.int32, device=_device(params))
    return {"params": params, "opt": adamw_init(params), "step": step}


def _batch(cfg, b=2, s=8, device="cpu"):
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(2, cfg.vocab_size, (b, s + 1), generator=g)
    return {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}


def _device(params):
    return params["embed"].device


def _copy_params(params):
    if isinstance(params, dict):
        return {k: _copy_params(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_copy_params(v) for v in params]
    return params.clone()


# ------------------------------------------------------------ the recorder
@pytest.mark.parametrize("path", ["serve", "train"])
def test_tracing_off_records_nothing_and_enters_no_profiler_range(olmo, path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert telemetry.span("x") is telemetry.NO_SPAN
    params, cfg = olmo
    if path == "serve":
        srv = _server(olmo)
        for p in _prompts([3, 5]):
            srv.submit(p)
        srv.step()
        assert all(r.admitted_at is not None for r in srv._slot_req if r is not None)
    else:
        step = make_train_step(cfg)
        step(_train_state(cfg, _copy_params(params)), _batch(cfg))
    assert telemetry.spans() == [] and telemetry.spans_dropped() == 0


@pytest.mark.parametrize("profile", [
    lambda: torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]),
    lambda: torch.autograd.profiler.profile(),
], ids=["torch.profiler", "autograd.profiler"])
def test_the_flag_follows_a_profiler_session(profile):
    assert not telemetry.profiler_recording() and telemetry.span("x") is telemetry.NO_SPAN
    with profile():
        assert telemetry.profiler_recording()
        with telemetry.span("inside") as sp:
            pass
    assert not telemetry.profiler_recording() and telemetry.span("x") is telemetry.NO_SPAN
    assert telemetry.spans() == [sp] and sp.device_ms is None      # no card: no device time


def test_set_tracing_records_without_a_profiler():
    telemetry.set_tracing(True)
    assert not telemetry.profiler_recording()
    with telemetry.span("outer", items=2) as outer:
        with telemetry.span("inner") as inner:
            inner.count(items=3)
            inner.count(items=4, other=1)
            inner.stamp("mark", 1.5)
    assert [s.name for s in telemetry.spans()] == ["inner", "outer"]     # in finishing order
    assert inner.parent == outer.id and outer.parent == 0 and inner.id > outer.id
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert inner.counts == {"items": 7, "other": 1} and outer.counts == {"items": 2}
    assert inner.stamps == {"mark": 1.5}
    assert telemetry.spans(since=inner.t0) == [inner]
    assert telemetry.spans(until=inner.t0) == [outer]


def test_the_store_is_bounded_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(telemetry, "_STORE", telemetry.SpanStore(4))
    telemetry.set_tracing(True)
    for i in range(10):
        with telemetry.span(f"s{i}"):
            pass
    assert [s.name for s in telemetry.spans()] == ["s6", "s7", "s8", "s9"]
    assert telemetry.spans_dropped() == 6
    telemetry.clear_spans()
    assert telemetry.spans() == [] and telemetry.spans_dropped() == 0
    with telemetry.span("again"):
        pass
    assert len(telemetry.spans()) == 1


# ------------------------------------------------------------ the server
def test_server_spans_sit_inside_the_callers_label(olmo):
    srv = _server(olmo)
    for p in _prompts([3, 5, 9]):
        srv.submit(p)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            with torch.profiler.record_function("caller.step"):
                srv.step()
    notes = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events() if e.is_user_annotation()),
                   key=lambda n: n[1])
    callers = [n for n in notes if n[0] == "caller.step"]
    assert len(callers) == 2
    for _, a, b in callers:
        inside = [n[0] for n in notes if n[0].startswith("serve.") and a <= n[1] and n[2] <= b]
        assert inside == list(SERVE_NAMES)                   # at most three a step
    assert [n[0] for n in notes if n[0].startswith("serve.")] == list(SERVE_NAMES) * 2


@pytest.mark.parametrize("chunk, lengths, steps", [
    # widths 4, 8, 16, 16 (17 keeps its last 16): one step takes all four
    (64, [3, 5, 9, 17], [(4, 3 + 5 + 9 + 16, 4 + 8 + 16 + 16)]),
    # a 16-token chunk: 4 + 8, then 16, then 16
    (16, [3, 5, 9, 17], [(2, 8, 12), (1, 9, 16), (1, 16, 16)]),
])
def test_admission_counts_by_hand(olmo, chunk, lengths, steps):
    telemetry.set_tracing(True)
    srv = _server(olmo, prefill_chunk=chunk, max_new_tokens=30)
    for p in _prompts(lengths):
        srv.submit(p)
    for _ in steps:
        srv.step()
    admits = [s for s in telemetry.spans() if s.name == "serve.admit"]
    assert [(s.counts["requests"], s.counts["kept"], s.counts["padded"]) for s in admits] == steps
    decodes = [s for s in telemetry.spans() if s.name == "serve.decode"]
    assert len(decodes) == len(steps) and all(s.counts == {"steps": 4} for s in decodes)
    assert all("launch" in s.stamps and s.t0 <= s.stamps["launch"] <= s.t1 for s in admits)


def test_gang_admission_counts_the_whole_batch(olmo):
    telemetry.set_tracing(True)
    srv = _server(olmo, mode="gang", max_new_tokens=3)
    for p in _prompts([3, 5, 9]):
        srv.submit(p)
    srv.run()
    names = [s.name for s in sorted(telemetry.spans(), key=lambda s: s.t0)]
    assert names == ["serve.admit", "serve.sync"] + ["serve.decode", "serve.sync"] * 2
    admit = next(s for s in telemetry.spans() if s.name == "serve.admit")
    assert admit.counts == {"requests": 3, "kept": 3 + 5 + 9, "padded": 4 * 16}
    first_fetch = next(s for s in telemetry.spans() if s.name == "serve.sync").stamps["fetched"]
    assert all(r.first_token_at == first_fetch for r in srv.results.values())


@pytest.mark.parametrize("tracing", [True, False], ids=["traced", "untraced"])
def test_request_stamps_follow_the_fetch(olmo, tracing):
    telemetry.set_tracing(tracing)
    srv = _server(olmo, max_batch=2, admission=1, max_new_tokens=5, sync_interval=2)
    for p in _prompts([3, 5, 9, 4]):
        srv.submit(p)
    srv.drain()
    reqs = sorted(srv.results.values(), key=lambda r: r.rid)
    assert len(reqs) == 4
    for r in reqs:
        assert r.submitted <= r.admitted_at <= r.first_token_at <= r.finished_at
    if tracing:
        syncs = sorted((s for s in telemetry.spans() if s.name == "serve.sync"),
                       key=lambda s: s.t0)
        for r in reqs:
            first = next(s for s in syncs if s.t0 > r.admitted_at)
            assert r.first_token_at == first.stamps["fetched"]
    else:
        assert telemetry.spans() == []


# ------------------------------------------------------------ the train step
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_spans_in_order(olmo, microbatches):
    params, cfg = olmo
    telemetry.set_tracing(True)
    step = make_train_step(cfg, microbatches=microbatches)
    step(_train_state(cfg, _copy_params(params)), _batch(cfg, b=2))
    got = sorted(telemetry.spans(), key=lambda s: s.t0)
    assert [s.name for s in got] == \
        ["train.forward", "train.backward"] * microbatches + ["train.optimizer"]
    assert all(a.t1 <= b.t0 for a, b in zip(got, got[1:]))          # one after another
    assert all(s.parent == 0 for s in got)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["serve", "train"])
def test_work_off_the_card_has_no_device_time_once_cuda_is_up(olmo, path):
    """A process that has started CUDA still times a CPU server or train
    step on the host alone: its spans have no device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.zeros(1, device="cuda")
    assert torch.cuda.is_initialized()
    telemetry.set_tracing(True)
    params, cfg = olmo
    if path == "serve":
        srv = _server(olmo)
        for p in _prompts([3, 5]):
            srv.submit(p)
        srv.step()
    else:
        make_train_step(cfg)(_train_state(cfg, _copy_params(params)), _batch(cfg))
    got = telemetry.spans()
    assert got and all(s.device_ms is None for s in got)


@pytest.mark.cuda
def test_train_spans_sum_to_the_step_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=2).validate()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = make_train_step(cfg)
    state = _train_state(cfg, params)
    batch = _batch(cfg, b=2, s=512, device=dev)
    state, _ = step(state, batch)                    # builds and warms
    torch.cuda.synchronize()
    telemetry.set_tracing(True)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    state, _ = step(state, batch)
    b.record()
    torch.cuda.synchronize()
    whole = a.elapsed_time(b)
    parts = {s.name: s.device_ms for s in telemetry.spans()}
    assert set(parts) == {"train.forward", "train.backward", "train.optimizer"}
    assert all(ms > 0 for ms in parts.values())
    assert sum(parts.values()) == pytest.approx(whole, rel=0.05), (parts, whole)
