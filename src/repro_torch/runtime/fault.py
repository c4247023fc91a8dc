"""Fault tolerance: heartbeats, straggler detection, failure/restart policy.

The port of ``repro/runtime/fault.py`` (numpy, a copy).

At 1000+ nodes the framework must assume hosts fail mid-run and some hosts
run slow (thermal throttling, flaky HBM, noisy neighbors).  This module is
the coordinator-side logic, written against an abstract host report stream
so it is fully testable on one machine (tests inject synthetic timelines):

  * ``HeartbeatMonitor`` — declares a host dead after ``timeout_s`` silence.
  * ``StragglerDetector`` — flags hosts whose per-step time exceeds
    ``factor`` × the fleet median over a sliding window (the mitigation at
    the launcher level is re-slotting the host's shard onto a hot spare; the
    step itself is one synchronous program, so mitigation happens
    *between* steps).
  * ``RestartPolicy`` — exponential-backoff restart budget; decides
    resume-from-checkpoint vs. elastic down-scale (runtime/elastic.py).
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional, Set

import numpy as np

__all__ = ["HeartbeatMonitor", "StragglerDetector", "RestartPolicy", "FaultEvent"]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str          # "dead" | "straggler" | "recovered"
    host: int
    step: Optional[int] = None
    detail: str = ""


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 now: Optional[float] = None):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        # Seed every host with the monitor's start time: a host that wedges
        # before its FIRST heartbeat must still time out.  (An empty map made
        # check() skip never-seen hosts, so a worker that hung in startup was
        # never declared dead.)
        start = time.monotonic() if now is None else now
        self.last_seen: Dict[int, float] = {h: start for h in range(n_hosts)}
        self._dead: Set[int] = set()

    def beat(self, host: int, now: Optional[float] = None) -> Optional[FaultEvent]:
        now = time.monotonic() if now is None else now
        self.last_seen[host] = now
        if host in self._dead:
            self._dead.discard(host)
            return FaultEvent("recovered", host)
        return None

    def check(self, now: Optional[float] = None) -> List[FaultEvent]:
        now = time.monotonic() if now is None else now
        events = []
        for h in range(self.n_hosts):
            seen = self.last_seen[h]
            if h not in self._dead and now - seen > self.timeout_s:
                self._dead.add(h)
                events.append(FaultEvent("dead", h, detail=f"silent {now - seen:.1f}s"))
        return events

    @property
    def dead(self) -> Set[int]:
        return set(self._dead)


class StragglerDetector:
    def __init__(self, n_hosts: int, window: int = 16, factor: float = 1.5,
                 min_steps: int = 4):
        self.window, self.factor, self.min_steps = window, factor, min_steps
        self.times: Dict[int, Deque[float]] = defaultdict(lambda: deque(maxlen=window))
        self._flagged: Set[int] = set()

    def record(self, host: int, step: int, seconds: float) -> None:
        self.times[host].append(seconds)

    def stragglers(self) -> List[FaultEvent]:
        means = {h: float(np.mean(t)) for h, t in self.times.items()
                 if len(t) >= self.min_steps}
        if len(means) < 2:
            return []
        med = float(np.median(list(means.values())))
        slow = {h for h, m in means.items() if m > self.factor * med}
        events = [FaultEvent("straggler", h, detail=f"{means[h] / med:.2f}x median")
                  for h in sorted(slow)]
        # a previously-flagged host that drops back under the threshold is
        # announced as recovered so the launcher can cancel re-slotting
        events += [FaultEvent("recovered", h, detail="back under threshold")
                   for h in sorted(self._flagged - slow) if h in means]
        self._flagged = slow
        return events


class RestartPolicy:
    """Budgeted exponential backoff; escalates to elastic down-scale.

    The budget *decays*: every ``decay_after_s`` of healthy runtime since the
    last fault forgives one restart, so a weeks-long job with occasional
    transient faults never exhausts the budget, while a crash-loop (faults
    faster than the decay interval) still aborts after ``max_restarts``.
    """

    def __init__(self, max_restarts: int = 5, base_backoff_s: float = 5.0,
                 decay_after_s: float = 300.0):
        self.max_restarts = max_restarts
        self.base_backoff_s = base_backoff_s
        self.decay_after_s = decay_after_s
        self.restarts = 0
        self._last_fault: Optional[float] = None

    def next_action(self, spare_hosts: int,
                    now: Optional[float] = None) -> Dict[str, object]:
        now = time.monotonic() if now is None else now
        if self._last_fault is not None and self.restarts > 0:
            healthy = max(0.0, now - self._last_fault)
            forgiven = int(healthy // self.decay_after_s)
            if forgiven:
                self.restarts = max(0, self.restarts - forgiven)
        self._last_fault = now
        if self.restarts >= self.max_restarts:
            return {"action": "abort", "reason": "restart budget exhausted"}
        self.restarts += 1
        backoff = self.base_backoff_s * (2 ** (self.restarts - 1))
        if spare_hosts > 0:
            return {"action": "restart_with_spare", "backoff_s": backoff}
        return {"action": "elastic_downscale", "backoff_s": backoff}
