"""The traced run: ``torch.profiler`` over the window, reduced in memory.

The harness labels what the host is doing with ``record_function`` spans of
its own (``traffic.wait``, ``server.step``, ``data.batch``, ``train.step``).
:func:`reduce` keeps the device's operations (kernels, copies, sets) inside
the window and works out the busy time (the union of their intervals), the
operations that took most time, and the idle gaps between them, each named
by the innermost host span that covers its middle.  No trace file is
written.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch

TOP = 10
NAME_CHARS = 160


def label(name: str):
    """A host span of the harness."""
    return torch.profiler.record_function(name)


class Window:
    """Clock readings of the measured window, on the host's monotonic clock
    and on the wall clock the profiler's timestamps use."""

    def __init__(self) -> None:
        self.t0 = self.t1 = 0.0
        self.ns0 = self.ns1 = 0

    def open(self) -> None:
        self.t0, self.ns0 = time.perf_counter(), time.time_ns()

    def close(self) -> None:
        self.t1, self.ns1 = time.perf_counter(), time.time_ns()

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def profiler(on: bool):
    """A profiler of host spans and device activity, or nothing."""
    if not on:
        return contextlib.nullcontext(None)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False,
                                  profile_memory=False)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(prof: Any, win: Window) -> Dict[str, Any]:
    """The device's work inside ``win``: ``ops`` [(name, start_ns, end_ns)],
    ``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` (the top
    :data:`TOP` by seconds)."""
    ops: List[Tuple[str, int, int]] = []
    spans: List[Tuple[str, int, int]] = []
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            a, b = max(a, win.ns0), min(b, win.ns1)
            if b > a:
                ops.append((e.name(), a, b))
        elif e.is_user_annotation():
            spans.append((e.name(), a, b))
    busy = _union([(a, b) for _, a, b in ops])
    busy_ns = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in ops:
        by_name[name[:NAME_CHARS]] += (b - a) * 1e-9
    gaps, prev = [], win.ns0
    for a, b in busy + [(win.ns1, win.ns1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    spans.sort(key=lambda s: s[1])
    starts = [a for _, a, _ in spans]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        idle[_host_span(spans, starts, (a + b) // 2)] += (b - a) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"ops": ops, "busy_s": busy_ns * 1e-9, "window_s": (win.ns1 - win.ns0) * 1e-9,
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def _host_span(spans: List[Tuple[str, int, int]], starts: List[int], t: int,
               depth: int = 8) -> str:
    """The innermost harness span covering ``t`` (``host.other`` if none),
    among the ``depth`` spans that start last before it (the harness's spans
    nest at most a few deep)."""
    best: Optional[Tuple[int, str]] = None
    i = bisect.bisect_right(starts, t)
    for name, a, b in spans[max(0, i - depth):i]:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else "host.other"


def kernel_seconds(summary: Dict[str, Any], part: str) -> Tuple[float, int]:
    """(seconds, calls) of the device operations whose name contains ``part``."""
    hits = [b - a for name, a, b in summary["ops"] if part in name]
    return sum(hits) * 1e-9, len(hits)
