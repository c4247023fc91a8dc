"""Shared micro-timing harness for tuning objectives.

The port of ``repro/launch/microbench.py``: raw per-call samples in
microseconds (the feed of :mod:`repro_torch.core.stats` and the campaign
gate), their median, and autotune candidates built through the step
registry (:mod:`repro_torch.core.compilecache`).

On the card a sample is the per-call time between two CUDA events around
``inner`` back-to-back calls, after a warm-up and a
``torch.cuda.synchronize()``.  The kernels the ``kernels`` grid tunes take
4–350 µs, and a wall clock around one synchronized call would measure the
host's sync latency instead (tens of µs): every candidate would then read
the same.  Before the first event the stream is held by a device-side
sleep (``torch.cuda._sleep``) as long as the host took to queue ``inner``
calls in the warm-up, so the calls run back to back on the card and the
events time the card's work, not the host's dispatch rate.  On the CPU a
sample is the wall clock of one call.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, List, Mapping

import numpy as np
import torch

from ..core.compilecache import CachedStep, cached_step

__all__ = ["candidate", "median_time_us", "time_samples_us"]

def candidate(component: str, fn: Callable[..., Any], settings: Mapping[str, Any],
              workload: str = "") -> CachedStep:
    """One autotune candidate through the step registry, under
    ``autotune.<component>`` and the context (workload, settings), as the
    reference's ``jit_candidate``: an optimizer revisiting a config gets the
    step it built before.  Calling it runs ``fn`` eagerly: a candidate is
    timed on the inputs it is given, and its objective is the kernel's own
    time, which a graph of one launch would not change."""
    ctx = tuple(sorted((k, repr(v)) for k, v in settings.items()))
    return cached_step(fn, key=f"autotune.{component}", context=(workload, ctx))


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.device.type == "cuda" for a in args)


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_us(device_index: int) -> float:
    """Cycles of ``torch.cuda._sleep`` per microsecond on this card."""
    cycles = 2_000_000
    torch.cuda._sleep(cycles // 10)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / (start.elapsed_time(end) * 1e3)


def time_samples_us(fn: Callable[..., Any], *args: Any, warmup: int = 1,
                    reps: int = 3, inner: int = 10) -> List[float]:
    """Raw per-call microseconds of ``fn(*args)``, warm-up discarded: one
    sample per rep (see the module docstring for how a sample is taken on
    the card and on the CPU)."""
    if not _on_cuda(args):
        for _ in range(max(warmup, 0)):
            fn(*args)
        times = []
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e6)
        return times
    inner = max(inner, 1)
    for _ in range(max(warmup, 1)):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn(*args)
    host_us = (time.perf_counter() - t0) * 1e6     # the host's time to queue `inner` calls
    torch.cuda.synchronize()
    hold = int(_sleep_cycles_per_us(torch.cuda.current_device()) * (1.5 * host_us + 50.0))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(max(reps, 1)):
        torch.cuda._sleep(hold)
        start.record()
        for _ in range(inner):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / inner)
    return times


def median_time_us(fn: Callable[..., Any], *args: Any, warmup: int = 1, reps: int = 3,
                   inner: int = 10) -> float:
    """Median of :func:`time_samples_us`."""
    return float(np.median(time_samples_us(fn, *args, warmup=warmup, reps=reps, inner=inner)))
