"""TTFT, TPOT and the p95 over every request that arrived in the window,
unfinished ones included, and the metric readers' arithmetic."""
import types

import pytest

from perfbench.lib.readings import p95_ms, tpot_s, ttft_s
from perfbench.lib.spec import metric_reader
from perfbench.lib.stats import percentile, spread


def req(sched, first=None, last=None, n=0, done=False, admitted=None, submitted=None):
    return types.SimpleNamespace(sched=sched, first=first, last=last, n=n, done=done,
                                 admitted=admitted, submitted=sched if submitted is None else submitted)


def record():
    reqs = [req(0.0, 0.5, 2.5, 5, True, 0.1),      # ttft 0.5, tpot 2.0 / 4
            req(1.0, 1.2, 1.2, 4, False, 1.1),     # still streaming at the drain's end
            req(2.0, None, None, 0, False, None)]  # never served
    return types.SimpleNamespace(in_window=reqs, drain_end=10.0)


def test_ttft_counts_unserved_requests_to_the_drain_end():
    assert ttft_s(record()) == pytest.approx([0.5, 0.2, 8.0])


def test_tpot_of_finished_streaming_and_unserved():
    assert tpot_s(record()) == pytest.approx([0.5, (10.0 - 1.2) / 3, 8.0])


def test_nearest_rank_percentile():
    v = list(range(1, 201))
    assert percentile(v, 95) == 190 and percentile(v, 50) == 100
    assert percentile([3.0], 95) == 3.0
    assert percentile(list(range(1, 21)), 95) == 19       # 1 of 20 beyond it
    assert percentile(list(range(1, 22)), 95) == 20       # 1 of 21 beyond it
    assert p95_ms([0.001] * 19 + [1.0]) == pytest.approx(1.0)
    assert p95_ms([0.001] * 9 + [1.0]) == pytest.approx(1000.0)
    assert p95_ms([]) is None


def test_spread_is_the_quartile_distance_over_the_median():
    assert spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_readers_of_the_window():
    steps = [{"t0": 0.0, "t1": 0.5, "live": 4, "admitted": 0, "tokens": 9, "window": False},
             {"t0": 0.5, "t1": 1.0, "live": 4, "admitted": 1, "tokens": 16, "window": True},
             {"t0": 1.0, "t1": 1.6, "live": 2, "admitted": 0, "tokens": 8, "window": True}]
    win = types.SimpleNamespace(seconds=1.1)
    rec = types.SimpleNamespace(steps=steps, window=win, max_batch=4, setup_s=3.0, trace=None,
                                in_window=record().in_window, drain_end=10.0)
    assert metric_reader("output_tokens_per_s")(rec) == pytest.approx(24 / 1.1)
    assert metric_reader("slot_occupancy.backlog")(rec) == pytest.approx(75.0)
    assert metric_reader("sched_step_ms.backlog")(rec) == pytest.approx(550.0)
    assert metric_reader("setup_s")(rec) == 3.0
    assert metric_reader("idle_share.backlog")(rec) is None
    assert metric_reader("queue_wait_p95_ms.paced")(rec) == pytest.approx(8000.0)
    assert metric_reader("ttft_p95_ms")(rec) == pytest.approx(8000.0)
