"""Serving cells: the port's ``BatchedServer`` under a chat mix.

Set-up draws the weights, builds one server with the cell's pinned settings,
and warms every prompt width the mix can give it (one request each) and the
decode step, so that each graph the window replays is captured before it
opens.  The window then drives ``submit``/``step``:

  * closed loop: ``clients`` clients each keep one request in the system,
    the next sent the moment the last completes; the window opens after the
    step that brings the admissions to ``max_batch`` (every slot has been
    filled once: admission, not the clock, ends the ramp);
  * open loop: arrivals on the mix's schedule, each submitted at the first
    step boundary after it is due and stamped with its *scheduled* time; the
    first ``lead_s`` seconds of arrivals are set-up, the window is the next
    ``--seconds``; after it, the loop goes on (arrivals too) until every
    request that arrived in the window has finished or had two syncs, at
    most ``drain_s`` seconds.

After each ``step()`` (which ends in the server's host sync) the harness
reads the token lists of the requests it submitted: a request's first token
is stamped at the step that delivered it, its last at the step that
delivered its last.  Requests are counted, never dropped: one with no token
by the end of the drain gets that end as its first-token time, one still
streaming gets that end as its last-token time.

:func:`check` then compares what the window served with the plain reference
(see :mod:`perfbench.lib.compare`).
"""
from __future__ import annotations

import time
import types
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..lib import program, trace
from ..lib.spec import log
from ..lib.compare import serve_gaps
from ..lib.yardstick import serve_flops
from ..reference.model import RefConfig
from ..traffic.generator import ServeMix, check_mix, prompt_width


class Tracked:
    """One request as the harness sees it from outside the server."""

    __slots__ = ("i", "req", "sched", "submitted", "admitted", "first", "last", "n", "syncs",
                 "done", "prompt", "kept", "width")

    def __init__(self, i: int, req: Any, sched: float, submitted: float, prompt: np.ndarray,
                 capacity: int):
        self.i, self.req, self.sched, self.submitted = i, req, sched, submitted
        self.admitted: Optional[float] = None
        self.first: Optional[float] = None
        self.last: Optional[float] = None
        self.n, self.syncs, self.done = 0, 0, False
        self.prompt = prompt
        self.kept = min(len(prompt), max(2, capacity // 2))
        self.width = prompt_width(len(prompt), capacity)


def run(r) -> types.SimpleNamespace:
    spec, cell, dev = r.spec, r.spec.cell, r.device
    check_mix(spec.traffic)
    cfg = program.model_config(spec.config)
    m = RefConfig.from_file(spec.config)
    program.pin(cell["components"])
    from repro_torch.runtime.serve_loop import BatchedServer

    raw, params = program.draw_weights(cfg, r.seed, spec.config["init_std"], dev)
    log(f"weights drawn: {cfg.name}")
    sv = cell["server"]
    settings = cell["components"]["torch_serve_batching"]
    srv = BatchedServer(params, cfg, capacity=sv["capacity"], eos_id=sv["eos_id"], device=dev,
                        step=r.step or sv["step"], settings=settings)
    mix = ServeMix(spec.traffic, m.vocab, r.seed)
    rec = types.SimpleNamespace(kind="serve", model=m, raw=raw, server=srv, capacity=sv["capacity"],
                                max_batch=settings["max_batch"], seed=r.seed)

    # set-up: one request at every prompt width, every step captured
    rng = np.random.default_rng(program.sub_seed(r.seed, "warm-up"))
    for w in mix.widths(sv["capacity"]):
        srv.submit(rng.integers(2, m.vocab, size=w).astype(np.int32), budget=2 * srv.sync_interval)
    while srv.queue or srv.live_slots:
        srv.step()
    program.sync(dev)
    captures = program.cache_captures()
    log(f"set-up: weights, {len(mix.widths(sv['capacity']))} widths warmed, "
        f"{captures:.0f} graphs captured")

    loop = _Loop(r, srv, mix, m, rec)
    with trace.profiler(r.trace) as prof:
        if mix.loop == "closed":
            loop.closed(spec.traffic["clients"])
        else:
            loop.open(spec.traffic["lead_s"], spec.traffic["drain_s"])
    rec.setup_s = rec.window.t0 - r.started
    done = [t for t in rec.tracked if t.done and rec.window.t0 < t.last <= rec.window.t1]
    log(f"window {rec.window.seconds:.3f} s, {sum(s['window'] for s in rec.steps)} steps, "
        f"{len(rec.in_window)} requests counted, {len(done)} completed in it "
        f"({len(done) / rec.window.seconds:.3f} a second)")
    if program.cache_captures() != captures:
        raise RuntimeError(f"{program.cache_captures() - captures:.0f} graph captures after set-up")
    rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec.trace = trace.reduce(prof, rec.window) if prof is not None else None
    if rec.trace is not None:
        log(f"trace reduced: {len(rec.trace['ops'])} device operations in the window")
    return rec


class _Loop:
    """The window's loop and its stamps (module docstring)."""

    def __init__(self, r, srv, mix: ServeMix, m: RefConfig, rec) -> None:
        self.r, self.srv, self.mix, self.m, self.rec = r, srv, mix, m, rec
        self.tracked: List[Tracked] = []
        self.active: List[Tracked] = []
        self.steps: List[Dict[str, Any]] = []
        self.next_i = 0
        self.win = trace.Window()
        self.in_window = False
        self.flops = 0.0                # model FLOPs of the work delivered in the window
        self.prefill_widths: List[int] = []
        rec.window, rec.tracked, rec.steps = self.win, self.tracked, self.steps

    def submit(self, sched: Optional[float] = None) -> Tracked:
        prompt, budget = self.mix.request(self.next_i)
        now = time.perf_counter()
        self.srv.submit(prompt, budget=budget, submitted=now if sched is None else sched)
        t = Tracked(self.next_i, self.srv.queue[-1], now if sched is None else sched, now, prompt,
                    self.rec.capacity)
        self.next_i += 1
        self.tracked.append(t)
        self.active.append(t)
        return t

    def step(self) -> List[Tracked]:
        """One server step and the stamps it gives; returns the requests that
        finished at it."""
        live = self.srv.live_slots
        t0 = time.perf_counter()
        with trace.label("server.step"):
            self.srv.step()
        t1 = time.perf_counter()
        admitted = delivered = 0
        finished, still = [], []
        for t in self.active:
            req = t.req
            if t.admitted is None and req.slot >= 0:
                t.admitted = t0
                admitted += 1
                if self.in_window:
                    self.flops += serve_flops(self.m, t.kept, 0, 1)
                    self.prefill_widths.append(t.width)
            n = len(req.tokens)
            if n > t.n:
                if self.in_window:
                    delivered += n - t.n
                    for j in range(max(t.n, 1), n):      # token j ≥ 1 is one decode step's
                        self.flops += serve_flops(self.m, 1, t.kept + j - 1, 1)
                if t.n == 0:
                    t.first = t1
                t.last, t.n, t.syncs = t1, n, t.syncs + 1
            if req.done:
                t.done = True
                finished.append(t)
            else:
                still.append(t)
        self.active = still
        self.steps.append({"t0": t0, "t1": t1, "live": live + admitted, "admitted": admitted,
                           "tokens": delivered, "window": self.in_window})
        return finished

    def _open_window(self, at: Optional[float] = None) -> None:
        self.win.open()
        if at is not None:                     # a scheduled opening, already passed by little
            self.win.ns0 -= int((self.win.t0 - at) * 1e9)
            self.win.t0 = at
        self.in_window = True

    def _close_window(self) -> None:
        self.win.close()
        self.in_window = False
        self.rec.flops = self.flops
        self.rec.prefill_widths = self.prefill_widths

    def closed(self, clients: int) -> None:
        admitted = 0
        for _ in range(clients):
            self.submit()
        seconds = self.r.seconds
        while True:
            done = self.step()
            for _ in done:
                self.submit()
            admitted += self.steps[-1]["admitted"]
            if not self.in_window and admitted >= self.rec.max_batch:
                self._open_window()
            elif self.in_window and time.perf_counter() - self.win.t0 >= seconds:
                self._close_window()
                break
        self.rec.in_window = [t for t in self.tracked if t.first is not None
                              and t.last is not None and t.last > self.win.t0]
        self.rec.drain_end = self.win.t1

    def open(self, lead: float, drain: float) -> None:
        start = time.perf_counter()
        w0, w1 = start + lead, start + lead + self.r.seconds
        window: List[Tracked] = []
        pending = self.mix.arrival(self.next_i)
        while True:
            now = time.perf_counter()
            with trace.label("traffic.wait"):
                while start + pending <= now:
                    t = self.submit(sched=start + pending)
                    if w0 <= t.sched < w1:
                        window.append(t)
                    pending = self.mix.arrival(self.next_i)
            if not self.in_window and self.win.t1 == 0.0 and now >= w0:
                self._open_window(at=w0)
            if self.in_window and now >= w1:
                self._close_window()
            if self.win.t1 and (now >= self.win.t1 + drain
                                or all(t.done or t.syncs >= 2 for t in window)):
                break
            if not self.srv.queue and not self.srv.live_slots:
                with trace.label("traffic.wait"):
                    time.sleep(max(0.0, min(start + pending - time.perf_counter(), 0.01)))
                continue
            self.step()
        self.rec.in_window = window
        self.rec.drain_end = time.perf_counter()


def check(rec, r, control: bool = False) -> Dict[str, Any]:
    """Free the server and compare a sample of the requests it finished with
    the reference (and, ``control``, under ``"control"`` the reference in
    lower precision put in the program's place)."""
    cell = r.spec.cell["check"]
    finished = sorted((t for t in rec.tracked if t.done), key=lambda t: t.i)
    rng = np.random.default_rng(program.sub_seed(r.seed, "sample"))
    longest = max(finished, key=lambda t: (t.n, -t.i))
    others = [t for t in finished if t is not longest]
    pick = [longest] + [others[k] for k in sorted(rng.choice(len(others),
                                                             size=min(cell["sample"] - 1,
                                                                      len(others)),
                                                             replace=False))]
    seqs = [(t.prompt[-t.kept:], t.width, list(t.req.tokens)) for t in pick]
    rec.server = None
    rec.tracked = rec.in_window = None
    program.release()
    return serve_gaps(rec.raw, rec.model, seqs, r.device, control=control)


def counts(rec):
    """(attempted, failed): the requests counted in the window, and those of
    them that had no token by the drain's end."""
    return len(rec.in_window), sum(t.first is None for t in rec.in_window)
