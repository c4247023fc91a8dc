"""The readers of the program's own spans, counts and stamps
(:mod:`perfbench.lib.spans`): their arithmetic on hand-made records, and a
tiny CPU cell of each kind run with the port's tracing on, in which the
count and stamp readers give numbers and the device readers give None
(there is no device time off the card)."""
import types

import pytest
import torch

from perfbench.lib.spec import metric_reader
from perfbench.tests.tiny import tiny_run

SERVE_DEVICE = ["decode_step_ms.backlog", "decode_step_ms.paced", "prefill_ms_per_ktok.paced"]
TRAIN_DEVICE = ["train_forward_ms", "train_backward_ms", "train_optimizer_ms"]


def span(name, t0, t1, device_ms=None, counts=None, stamps=None):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, device_ms=device_ms,
                                 counts=counts or {}, stamps=stamps or {})


@pytest.fixture
def recorded(monkeypatch):
    """Hand the readers ``spans`` in place of the port's store."""
    from repro_torch.core import telemetry

    kept = []

    def between(since=None, until=None):
        return [s for s in kept if (since is None or s.t0 >= since)
                and (until is None or s.t0 < until)]

    monkeypatch.setattr(telemetry, "spans", between)
    return kept


def serve_spans():
    """Two server steps in a window [1, 3), one before it: the second step
    admits nothing, so its first launch is its decode's start."""
    return [
        span("serve.admit", 0.0, 0.1, 9.0, {"requests": 1, "kept": 10, "padded": 16}, {"launch": 0.05}),
        span("serve.sync", 0.5, 0.6, 0.0, stamps={"fetched": 0.55}),
        span("serve.admit", 1.0, 1.1, 4.0, {"requests": 2, "kept": 20, "padded": 32},
             {"launch": 1.05}),
        span("serve.decode", 1.1, 1.5, 360.0, {"steps": 4}),
        span("serve.sync", 1.5, 1.6, 0.01, stamps={"fetched": 1.52}),
        span("serve.admit", 1.6, 1.61, 0.002, {"requests": 0, "kept": 0, "padded": 0}),
        span("serve.decode", 1.62, 2.0, 380.0, {"steps": 4}),
        span("serve.sync", 2.0, 2.1, 0.01, stamps={"fetched": 2.03}),
    ]


def test_serve_readers_of_the_window(recorded):
    recorded.extend(serve_spans())
    rec = types.SimpleNamespace(window=types.SimpleNamespace(t0=1.0, t1=3.0))
    assert metric_reader("decode_step_ms.backlog")(rec) == pytest.approx(740.0 / 8)
    assert metric_reader("decode_step_ms.paced")(rec) == pytest.approx(740.0 / 8)
    # the admission with nothing prefilled is left out
    assert metric_reader("prefill_ms_per_ktok.paced")(rec) == pytest.approx(4.0 / 0.032)
    assert metric_reader("prefill_pad_share.backlog")(rec) == pytest.approx(100.0 * 12 / 32)
    # one pair inside the window: fetched 1.52, next first launch the decode at 1.62
    assert metric_reader("host_turnaround_ms.backlog")(rec) == pytest.approx(100.0)


def test_device_readers_read_nothing_without_device_time(recorded):
    recorded.extend(span(s.name, s.t0, s.t1, None, s.counts, s.stamps) for s in serve_spans())
    rec = types.SimpleNamespace(window=types.SimpleNamespace(t0=1.0, t1=3.0))
    assert all(metric_reader(m)(rec) is None for m in SERVE_DEVICE)
    assert metric_reader("prefill_pad_share.backlog")(rec) is not None


def test_train_readers_of_the_window(recorded):
    for i in range(3):                       # three steps from t = 1; one before the window
        t = float(i)
        recorded.extend([span("train.forward", t, t + 0.2, 200.0 + i),
                         span("train.backward", t + 0.2, t + 0.8, 800.0 + i),
                         span("train.optimizer", t + 0.8, t + 0.9, 30.0 + i)])
    rec = types.SimpleNamespace(window=types.SimpleNamespace(t0=1.0, t1=3.0), window_steps=2)
    assert metric_reader("train_forward_ms")(rec) == pytest.approx(201.5)
    assert metric_reader("train_backward_ms")(rec) == pytest.approx(801.5)
    assert metric_reader("train_optimizer_ms")(rec) == pytest.approx(31.5)


def test_stamp_readers(recorded):
    def tracked(submitted, admitted, first):
        return types.SimpleNamespace(req=types.SimpleNamespace(
            submitted=submitted, admitted_at=admitted, first_token_at=first))

    rec = types.SimpleNamespace(in_window=[tracked(0.0, 0.2, 0.6),
                                           tracked(1.0, 1.5, None),       # no token by the end
                                           tracked(2.0, None, None)],     # never admitted
                                drain_end=10.0)
    # nearest-rank p95 of three is the largest
    assert metric_reader("server_queue_wait_p95_ms.paced")(rec) == pytest.approx(8000.0)
    assert metric_reader("first_sync_wait_p95_ms.paced")(rec) == pytest.approx(8500.0)
    rec.in_window = rec.in_window[:1]
    assert metric_reader("server_queue_wait_p95_ms.paced")(rec) == pytest.approx(200.0)
    assert metric_reader("first_sync_wait_p95_ms.paced")(rec) == pytest.approx(400.0)


def test_a_program_without_spans_or_stamps_reads_nothing(monkeypatch):
    from repro_torch.core import telemetry

    monkeypatch.delattr(telemetry, "spans")
    win = types.SimpleNamespace(t0=0.0, t1=1.0)
    old = types.SimpleNamespace(req=types.SimpleNamespace(submitted=0.0))
    rec = types.SimpleNamespace(window=win, window_steps=3, in_window=[old], drain_end=1.0)
    names = SERVE_DEVICE + TRAIN_DEVICE + ["prefill_pad_share.backlog", "host_turnaround_ms.backlog",
                                           "server_queue_wait_p95_ms.paced",
                                           "first_sync_wait_p95_ms.paced"]
    assert all(metric_reader(m)(rec) is None for m in names)


@pytest.fixture
def traced():
    from repro_torch.core import compilecache, telemetry

    torch.set_num_threads(2)
    compilecache.clear_registry()
    telemetry.set_tracing(True)
    yield
    telemetry.set_tracing(False)
    telemetry.clear_spans()
    compilecache.clear_registry()


@pytest.mark.parametrize("cell, numbers, nothing", [
    ("olmo-1b.chat-backlog", ["prefill_pad_share.backlog", "host_turnaround_ms.backlog"],
     ["decode_step_ms.backlog"]),
    ("olmo-1b.chat-paced", ["server_queue_wait_p95_ms.paced", "first_sync_wait_p95_ms.paced"],
     ["decode_step_ms.paced", "prefill_ms_per_ktok.paced"]),
    ("olmo-1b.train-8x2048", [], TRAIN_DEVICE),
])
def test_a_tiny_cell_traced_on_the_cpu(traced, cell, numbers, nothing):
    import importlib

    from perfbench.lib import spans

    r = tiny_run(cell, seconds=1.0)
    rec = importlib.import_module(f"perfbench.kinds.{r.spec.cell['kind']}").run(r)
    for m in numbers:
        v = metric_reader(m)(rec)
        assert v is not None and v >= 0, m
    assert all(metric_reader(m)(rec) is None for m in nothing)
    names = {s.name for s in spans.window_spans(rec, "serve.admit", "serve.decode", "serve.sync",
                                                 "train.forward", "train.backward",
                                                 "train.optimizer")}
    assert names == ({"train.forward", "train.backward", "train.optimizer"} if not numbers
                     else {"serve.admit", "serve.decode", "serve.sync"})
