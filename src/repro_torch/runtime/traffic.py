"""Seeded traffic scenarios + open-loop replay for the serve engine.

ROADMAP item 1's traffic scenario engine: generators produce deterministic
arrival processes (request time, prompt tokens, output budget) from a seed,
and :func:`replay` drives a :class:`~repro_torch.runtime.serve_loop.BatchedServer`
open-loop — arrivals land at their scheduled times whether or not the server
has kept up, so queueing delay shows up in latency instead of silently
stretching the offered load.

Three canonical mixes:

  * ``diurnal``  — sinusoidally modulated Poisson arrivals (the daily ramp).
  * ``bursts``   — clumped arrivals: quiet gaps then near-simultaneous spikes.
  * ``heavy_tail`` — Poisson arrivals whose OUTPUT budgets are bimodal
    (mostly short, a long tail) — the convoy-effect scenario where gang
    scheduling stalls a whole batch behind its slowest member and
    continuous batching backfills freed slots.

Generators live in ``runtime`` (not ``benchmarks/``) so campaign measures
can replay the same mixes without importing benchmark harnesses.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np

__all__ = ["Arrival", "SCENARIOS", "diurnal", "bursts", "heavy_tail", "drifting",
           "replay"]


@dataclasses.dataclass(frozen=True)
class Arrival:
    at: float               # seconds from scenario start (scheduled, open-loop)
    prompt: np.ndarray      # token ids
    budget: int             # output-token budget for this request


def _prompt(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(2, vocab, size=max(2, int(n))).astype(np.int32)


def _poisson_times(rng: np.random.Generator, n: int, rate: float) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def diurnal(seed: int, n: int = 32, base_rate: float = 8.0, period: float = 4.0,
            vocab: int = 250) -> List[Arrival]:
    """Inhomogeneous Poisson ramp: rate(t) = base * (1 + 0.8 sin(2πt/period))."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(n):
        rate = base_rate * (1.0 + 0.8 * np.sin(2.0 * np.pi * t / period))
        t += float(rng.exponential(1.0 / max(rate, 1e-3)))
        out.append(Arrival(t, _prompt(rng, rng.integers(3, 17), vocab),
                           int(rng.integers(4, 13))))
    return out


def bursts(seed: int, n: int = 32, burst_size: int = 8, gap: float = 1.0,
           vocab: int = 250) -> List[Arrival]:
    """Clumped arrivals: quiet exponential gaps, then a near-simultaneous
    burst of ``burst_size`` requests."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while len(out) < n:
        t += float(rng.exponential(gap))
        for _ in range(min(burst_size, n - len(out))):
            t += float(rng.exponential(0.005))
            out.append(Arrival(t, _prompt(rng, rng.integers(3, 13), vocab),
                               int(rng.integers(4, 11))))
    return out


def heavy_tail(seed: int, n: int = 32, rate: float = 16.0, p_long: float = 0.2,
               short_max: int = 6, long_max: int = 48, vocab: int = 250) -> List[Arrival]:
    """Poisson arrivals, lognormal prompt widths, bimodal output budgets:
    most requests finish in a handful of tokens while a heavy tail runs an
    order of magnitude longer — the gang scheduler's worst case."""
    rng = np.random.default_rng(seed)
    times = _poisson_times(rng, n, rate)
    out = []
    for t in times:
        n_prompt = int(np.clip(rng.lognormal(np.log(8.0), 0.6), 2, 64))
        if rng.random() < p_long:
            budget = int(rng.integers(max(2, long_max // 2), long_max + 1))
        else:
            budget = int(rng.integers(2, short_max + 1))
        out.append(Arrival(float(t), _prompt(rng, n_prompt, vocab), budget))
    return out


def drifting(seed: int, n: int = 32, shift: float = 0.5, rate: float = 16.0,
             short_budget: int = 3, long_budget: int = 40,
             vocab: int = 250) -> List[Arrival]:
    """Traffic-MIX shift: the online-tuning scenario.

    Poisson arrivals whose output-budget regime flips mid-scenario: the first
    ``shift`` fraction are long decode-heavy completions (where a long sync
    interval amortizes the per-window host sync), the rest are short
    chat-style turns of a couple of tokens — under a long sync interval a
    slot that finishes early in the window burns the rest of it on wasted
    decode steps, and freed slots cannot be backfilled until the next sync
    boundary.  A config tuned for the first regime is structurally mistuned
    for the second, so a frozen server loses throughput at the shift — the
    gap online tuning must close.
    """
    rng = np.random.default_rng(seed)
    times = _poisson_times(rng, n, rate)
    k = int(np.clip(round(n * shift), 0, n))
    out = []
    for i, t in enumerate(times):
        if i < k:
            budget = int(rng.integers(max(2, 3 * long_budget // 4), long_budget + 1))
            n_prompt = int(rng.integers(4, 13))
        else:
            budget = int(rng.integers(2, short_budget + 1))
            n_prompt = int(rng.integers(3, 9))
        out.append(Arrival(float(t), _prompt(rng, n_prompt, vocab), budget))
    return out


SCENARIOS: Dict[str, Callable[..., List[Arrival]]] = {
    "diurnal": diurnal,
    "bursts": bursts,
    "heavy_tail": heavy_tail,
    "drifting": drifting,
}


def replay(server, arrivals: List[Arrival], speed: float = 0.0) -> Dict[str, float]:
    """Drive ``server`` through ``arrivals`` open-loop; returns run metrics.

    ``speed`` scales scenario time onto the wall clock (2.0 = twice as fast
    as scheduled); ``speed <= 0`` disables pacing — every request is offered
    up front (a closed burst), which is the deterministic mode benchmarks
    use for scheduler A/B runs.  Requests are stamped with their SCHEDULED
    arrival time, so queueing delay from a backed-up server counts against
    latency even though `submit` happens late.
    """
    server.begin_run()
    t0 = time.perf_counter()
    order = sorted(arrivals, key=lambda a: a.at)
    if speed <= 0.0:
        for a in order:
            server.submit(a.prompt, budget=a.budget)
        server.drain()
        return server.finish_run()
    i, n = 0, len(order)
    while i < n or server.queue or server.live_slots:
        now = (time.perf_counter() - t0) * speed
        while i < n and order[i].at <= now:
            a = order[i]
            server.submit(a.prompt, budget=a.budget,
                          submitted=t0 + a.at / speed)
            i += 1
        if not server.queue and not server.live_slots:
            if i < n:
                wait = (order[i].at - now) / speed
                time.sleep(min(max(wait, 0.0), 0.05))
            continue
        if server.mode == "continuous":
            server.step()
        else:
            server.drain()   # gang blocks here; later arrivals queue up
    return server.finish_run()
