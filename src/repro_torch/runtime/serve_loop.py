"""Serving loop: slot-level continuous batching with amortized host sync.

The port of ``repro/runtime/serve_loop.py``.  It serves every family whose
caches :mod:`repro_torch.models.model` builds (dense, ssm, hybrid): the
scheduler sees a cache only through ``init_cache`` and ``merge_slot``.  Two
schedulers over one model:

  * ``mode="continuous"`` (default) — each of the ``max_batch`` slots
    carries its own device state (current token, position, done flag, cache
    rows); a finished sequence frees its slot at the next sync and a waiting
    request is prefilled *into* that slot while every other slot keeps
    decoding.  The host reads token batches back once every
    ``sync_interval`` decode steps.
  * ``mode="gang"`` — the static-batching baseline: admit a full batch,
    decode until everyone finishes, sync every token.

Scheduler contract (the reference's):

  * Prompts are left-padded into a ``bucket_pow2`` width ``W``; the pad
    (token 0) is attended and roped, and generation starts at position
    ``W``.
  * Prompts longer than ``capacity // 2`` keep their most recent
    ``capacity // 2`` tokens, so ``W <= capacity``.
  * For non-windowed families the per-request budget is clipped to
    ``capacity - W`` (a full cache must not wrap).
  * ``admission`` bounds requests admitted per scheduler step and
    ``prefill_chunk`` the summed prompt widths (at least one request is
    always admitted).
  * Greedy decode; ``eos_id < 0`` disables EOS.

Host syncs: :func:`_host_fetch` is the only device→host read, one per
``sync_interval`` decode steps.  The scheduler keeps slot indices as Python
ints, the first token of a prefill stays a device tensor written into its
slot, and host data goes to the device only as copies (prompt tokens, the
slot index, the done mask).

Compiled steps.  The reference builds four sites through ``cached_jit``;
here each goes through :func:`repro_torch.core.compilecache.cached_step`
with the reference's key and context: ``serve.prefill``,
``serve.install_slot``, ``serve.decode_step`` (gang) and
``serve.decode_fused`` (decode, argmax, EOS folded into ``done``,
``pos + 1``).  Every step reads and writes the server's static buffers in
place: the per-slot ``tok``/``pos``/``done`` registers, the batched caches,
one prompt buffer per (rows, width bucket), and a ``(64, max_batch)``
history of each decode step's input token, which the sync reads back (a
static ``tok`` is overwritten by the next step, so a list of references to
it would read the last step's value ``sync_interval`` times).  An admission
is one program: the prefill and the install of its rows, one per (width
bucket, rows), rows 1 for a continuous slot and ``max_batch`` for a gang
batch.  ``step="graph"`` (the default on CUDA) runs each program as a CUDA
graph per shape class, owned by this server (:class:`compilecache.Graphs`);
``step="eager"`` runs the same bodies on the same buffers without capture
(the CPU's only path).  The hot-swap knobs need no recapture: no step reads
them.  The tuned settings the kernels read are resolved when a graph is
captured (see :mod:`repro_torch.core.compilecache`).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.compilecache import Graphs, cached_step, config_signature
from ..core.configstore import bucket_pow2
from ..core.registry import MetricSpec, tunable_component
from ..core.tunable import Int
from ..models import model as M
from ..models.config import ModelConfig

__all__ = ["serve_settings", "ServeSettings", "BatchedServer", "workload_signature",
           "HOT_SWAP_KNOBS", "COMPONENT", "STEPS", "HISTORY"]

# Tunables swappable on a LIVE server between steps (see apply_config): pure
# scheduling knobs.  max_batch (and capacity) size the device state built at
# __init__ — changing them means building a new server.
HOT_SWAP_KNOBS = ("admission", "prefill_chunk", "sync_interval", "max_new_tokens")
COMPONENT = "torch_serve_batching"
STEPS = ("graph", "eager")


@tunable_component(
    name=COMPONENT,
    tunables=(
        Int("max_batch", default=8, low=1, high=256, log=True),
        Int("max_new_tokens", default=32, low=1, high=4096, log=True),
        Int("admission", default=4, low=1, high=64, log=True),
        Int("prefill_chunk", default=64, low=8, high=4096, log=True),
        Int("sync_interval", default=4, low=1, high=64, log=True),
    ),
    metrics=(MetricSpec("tokens_per_s", "d"), MetricSpec("p50_latency_s", "d"),
             MetricSpec("queue_depth", "d"), MetricSpec("live_slots", "d")),
)
class ServeSettings:
    pass


serve_settings = ServeSettings()
# decode steps one sync can read back from the history: sync_interval's high
HISTORY = ServeSettings.mlos_meta.space["sync_interval"].high


def workload_signature(family: str, capacity: int) -> str:
    """Model family × bucketed cache capacity."""
    return f"{family}_c{bucket_pow2(capacity)}"


def resolve_step(step: Optional[str], device: torch.device) -> str:
    """``step`` as the server will run it: ``None`` means ``"graph"`` on
    CUDA and ``"eager"`` elsewhere; a graph anywhere but CUDA raises."""
    step = step or ("graph" if device.type == "cuda" else "eager")
    if step not in STEPS:
        raise ValueError(f"unknown step {step!r}; choose one of {STEPS}")
    if step == "graph" and device.type != "cuda":
        raise ValueError(f"step='graph' captures CUDA graphs; the server is on {device}")
    return step


# ---------------------------------------------------------------- step bodies
# Module-level functions of their arguments (and of the partial's config),
# so the registry's steps hold no server: a server's buffers live as long
# as the server does.
def _prefill(params: Dict[str, Any], tokens: torch.Tensor, *, cfg: ModelConfig, capacity: int):
    return M.prefill(params, cfg, tokens, capacity)


def _admit(params, tokens, slots, caches, tok, pos, done, *, prefill, install) -> None:
    """Prefill ``tokens`` and install its rows into ``slots`` of the state."""
    logits, small, width = prefill(params, tokens)
    install(caches, small, slots, tok, pos, done, logits, width)


def _gang_decode(params, tok, caches, pos, *, cfg: ModelConfig) -> None:
    logits, _ = M.decode_step(params, cfg, tok, caches, pos)
    tok.copy_(torch.argmax(logits, -1))
    pos.add_(1)


def _decode_fused(params, tok, caches, pos, done, hist, hist_row, *, cfg: ModelConfig,
                  eos_id: int) -> None:
    """Record the step's input token in the history, decode, argmax, fold
    EOS into ``done``, ``pos + 1``; all in place."""
    hist.index_copy_(0, hist_row, tok[None])
    hist_row.add_(1)
    logits, _ = M.decode_step(params, cfg, tok, caches, pos)
    nxt = torch.argmax(logits, -1)
    done.logical_or_(nxt == eos_id)
    tok.copy_(nxt)
    pos.add_(1)


def _check_interval(n: int) -> int:
    if n > HISTORY:
        raise ValueError(f"sync_interval {n} > {HISTORY}: a sync reads back at most "
                         f"{HISTORY} decode steps")
    return n


def _host_fetch(x: torch.Tensor) -> np.ndarray:
    """The ONE sanctioned device→host transfer in the serve loop.

    Every read of device values funnels through here so tests can count
    host syncs by monkeypatching this name; the continuous engine calls it
    exactly once per ``sync_interval`` decode steps."""
    return x.cpu().numpy()


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    submitted: float
    budget: Optional[int] = None            # per-request token budget override
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finished_at: float = 0.0
    slot: int = -1
    eff_budget: int = 0                     # resolved (clipped) budget at admission


class BatchedServer:
    """Greedy-decoding batched server over a fixed batch-slot layout.

    Fixed shapes (batch = max_batch, cache = capacity) for the whole run;
    empty slots decode garbage that is discarded.  ``settings`` pins
    explicit tunable values; anything not pinned resolves through
    ``serve_settings.settings_for(workload)``.  ``emitter`` is a
    :class:`~repro_torch.core.telemetry.TelemetryEmitter` bound to
    ``torch_serve_batching`` on an MLOS channel (or any object with
    ``.emit(dict)``); it receives rolling tokens/s, p50 latency, queue
    depth and live slots at each sync and the run's totals at its end.
    ``params`` must already live on ``device``.  ``step`` chooses how the
    compiled steps run (see the module docstring): ``"graph"``, the
    default on CUDA, or ``"eager"``; it is not a tunable.
    """

    def __init__(self, params: Dict[str, Any], cfg: ModelConfig, capacity: int = 256,
                 eos_id: int = 1, workload: Optional[str] = None,
                 mode: str = "continuous", settings: Optional[Dict[str, int]] = None,
                 emitter: Optional[Any] = None, device: Union[str, torch.device] = "cuda",
                 step: Optional[str] = None):
        if mode not in ("continuous", "gang"):
            raise ValueError(f"unknown serve mode {mode!r}")
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, server on {self.device}")
        self.step_mode = resolve_step(step, self.device)
        self.params, self.cfg, self.capacity, self.eos_id = params, cfg, capacity, eos_id
        self.mode = mode
        self.emitter = emitter
        self.workload = workload or workload_signature(cfg.family, capacity)
        s = serve_settings.settings_for(self.workload)
        o = dict(settings or {})
        self.max_batch = int(o.get("max_batch", s["max_batch"]))
        self.max_new_tokens = int(o.get("max_new_tokens", s["max_new_tokens"]))
        self.admission = int(o.get("admission", s["admission"]))
        self.prefill_chunk = int(o.get("prefill_chunk", s["prefill_chunk"]))
        self.sync_interval = _check_interval(int(o.get("sync_interval", s["sync_interval"])))
        self._axes = M.cache_batch_axes(cfg, self.max_batch, capacity)

        # the reference's four compiled sites, keyed and contexted as there
        sig = config_signature(cfg)
        self._prefill_step = cached_step(
            functools.partial(_prefill, cfg=cfg, capacity=capacity),
            key="serve.prefill", context=(sig, self.workload, capacity))
        self._install_step = cached_step(
            functools.partial(M.install_slot, batch_axes=self._axes),
            key="serve.install_slot", context=(sig, self.workload, capacity, self.max_batch))
        self._gang_step = cached_step(
            functools.partial(_gang_decode, cfg=cfg),
            key="serve.decode_step", context=(sig, self.workload, capacity, self.max_batch))
        self._fused_step = cached_step(
            functools.partial(_decode_fused, cfg=cfg, eos_id=eos_id),
            key="serve.decode_fused",
            context=(sig, self.workload, capacity, self.max_batch, eos_id))
        self._admit_fn = functools.partial(_admit, prefill=self._prefill_step,
                                           install=self._install_step)
        self.graphs = Graphs(capture=self.step_mode == "graph")
        self._admit_steps: Dict[Tuple[int, int], Any] = {}   # (rows, width) -> bound step
        self._decode_bound = None

        self.queue: Deque[_Request] = deque()
        self.results: Dict[int, _Request] = {}
        self._next_rid = 0
        # per-slot device state; empty slots start done.  Static buffers: the
        # steps write them in place and the server never rebinds them.
        self._slot_req: List[Optional[_Request]] = [None] * self.max_batch
        self._free: List[int] = list(range(self.max_batch))
        self._caches = None                 # lazily built on first admission
        dev = self.device
        self._tok = torch.zeros((self.max_batch,), dtype=torch.long, device=dev)
        self._pos = torch.zeros((self.max_batch,), dtype=torch.long, device=dev)
        self._done = torch.ones((self.max_batch,), dtype=torch.bool, device=dev)
        self._hist = torch.zeros((HISTORY, self.max_batch), dtype=torch.long, device=dev)
        self._hist_row = torch.zeros((1,), dtype=torch.long, device=dev)
        self._slot = torch.zeros((1,), dtype=torch.long, device=dev)
        self._all_slots = torch.arange(self.max_batch, device=dev)
        self._prompts: Dict[Tuple[int, int], torch.Tensor] = {}
        self.decode_steps = 0               # lifetime counters
        self.decode_syncs = 0
        self.prefill_calls = 0
        self._begin_run(None)

    # ------------------------------------------------------------- admission
    def submit(self, prompt: np.ndarray, budget: Optional[int] = None,
               submitted: Optional[float] = None) -> int:
        """Queue a request.  ``submitted`` backdates the arrival (open-loop
        replay stamps the SCHEDULED time so queueing delay counts)."""
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(_Request(rid, np.asarray(prompt, np.int32),
                                   submitted if submitted is not None
                                   else time.perf_counter(), budget=budget))
        return rid

    def _n_live(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def live_slots(self) -> int:
        return self._n_live()

    def _width_of(self, n_prompt: int) -> int:
        keep = min(n_prompt, max(2, self.capacity // 2))
        return max(2, bucket_pow2(keep))

    def _pad_prompts(self, reqs: List[_Request], rows: int, width: int) -> torch.Tensor:
        """Left-pad (token 0) each prompt's tail into a (rows, width) device
        tensor; the host buffer is pinned so the copy does not block."""
        toks = np.zeros((rows, width), np.int64)
        for i, r in enumerate(reqs):
            n = min(len(r.prompt), width)
            if n:
                toks[i, -n:] = r.prompt[-n:]  # left-pad; keep the prompt tail
        host = torch.from_numpy(toks)
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _eff_budget(self, r: _Request, width: int) -> int:
        b = r.budget or self._budget_override or self.max_new_tokens
        if not self.cfg.window:
            b = min(b, self.capacity - width)  # full cache must not wrap
        return max(1, b)

    def _ensure_state(self) -> None:
        if self._caches is None:
            self._caches = M.init_cache(self.cfg, self.max_batch, self.capacity,
                                        device=self.device)

    def _run_admission(self, reqs: List[_Request], rows: int, width: int,
                       slots: torch.Tensor) -> None:
        """One admission program: prefill ``reqs`` (padded to ``rows``) at
        ``width`` and install row i into ``slots[i]`` of the state."""
        self._ensure_state()
        key = (rows, width)
        prompts = self._prompts.get(key)
        if prompts is None:
            prompts = self._prompts[key] = torch.zeros((rows, width), dtype=torch.long,
                                                       device=self.device)
        prompts.copy_(self._pad_prompts(reqs, rows, width))
        bound = self._admit_steps.get(key)
        if bound is None:
            bound = self._admit_steps[key] = self.graphs.bind(
                "serve.prefill", self._admit_fn, self.params, prompts, slots, self._caches,
                self._tok, self._pos, self._done)
        bound()
        self.prefill_calls += 1

    def _admit(self) -> int:
        """Prefill waiting requests into free slots; bounded per step by the
        ``admission`` count and the ``prefill_chunk`` width budget."""
        admitted, token_budget = 0, self.prefill_chunk
        while self._free and self.queue and admitted < self.admission:
            width = self._width_of(len(self.queue[0].prompt))
            if admitted and token_budget < width:
                break                        # chunk full; never starves (>=1 admitted)
            r = self.queue.popleft()
            token_budget -= width
            admitted += 1
            self._free.sort()
            slot = self._free.pop(0)
            self._prefill_into(slot, r, width)
        return admitted

    def _prefill_into(self, slot: int, r: _Request, width: int) -> None:
        # install IN PLACE: the slot's cache rows and (tok, pos, done)
        # registers.  The first token stays on device: it flows into the
        # decode stream and reaches the host with the next batched sync.
        self._slot.fill_(slot)
        self._run_admission([r], 1, width, self._slot)
        r.slot = slot
        r.eff_budget = self._eff_budget(r, width)
        self._slot_req[slot] = r

    def _decode(self) -> None:
        """One fused decode step over every slot; EOS tracking stays on device."""
        if self._decode_bound is None:
            self._decode_bound = self.graphs.bind(
                "serve.decode_fused", self._fused_step, self.params, self._tok, self._caches,
                self._pos, self._done, self._hist, self._hist_row)
        self._decode_bound()

    # ------------------------------------------------------- continuous loop
    def begin_run(self, max_new_tokens: Optional[int] = None) -> None:
        """Reset per-run accounting; open-loop callers call this, then
        :meth:`submit` + :meth:`step` as traffic arrives, then
        :meth:`finish_run`."""
        self._begin_run(max_new_tokens)

    def _begin_run(self, budget_override: Optional[int]) -> None:
        self._budget_override = budget_override
        self._run_completed: List[_Request] = []
        self._run_steps = 0
        self._run_syncs = 0
        self._run_t0 = time.perf_counter()
        self._win_tokens = 0
        self._win_completed: List[_Request] = []
        self._win_t0 = self._run_t0
        self.last_window: Optional[Dict[str, float]] = None

    # ------------------------------------------------------ live config swap
    def current_config(self) -> Dict[str, int]:
        """Snapshot of the scheduler knobs this server is running right now."""
        return {"max_batch": self.max_batch, "max_new_tokens": self.max_new_tokens,
                "admission": self.admission, "prefill_chunk": self.prefill_chunk,
                "sync_interval": self.sync_interval}

    def apply_config(self, settings: Dict[str, Any]) -> None:
        """Hot-swap scheduler knobs on a live server, between :meth:`step`
        calls.  Only :data:`HOT_SWAP_KNOBS` are accepted; the swap never
        perturbs a request's token stream, and :func:`_host_fetch` still runs
        once per ``sync_interval`` decode steps.  ``max_batch`` raises."""
        bad = [k for k in settings if k not in HOT_SWAP_KNOBS]
        if bad:
            raise ValueError(f"not hot-swappable on a live server: {bad} "
                             f"(allowed: {list(HOT_SWAP_KNOBS)})")
        if "sync_interval" in settings:
            _check_interval(max(1, int(settings["sync_interval"])))
        for k, v in settings.items():
            setattr(self, k, max(1, int(v)))

    def step(self) -> List[_Request]:
        """One scheduler step: admit into free slots, run ``sync_interval``
        decode steps on device, then one host sync.  Returns the requests
        that completed at this sync."""
        self._admit()
        if not self._n_live():
            return []
        n = self.sync_interval
        for _ in range(n):
            # each step CONSUMES self._tok and records it in the history, so
            # the history's rows are exactly the generated-token stream, the
            # prefill's first token included, with no extra host reads
            self._decode()
            self.decode_steps += 1
            self._run_steps += 1
        finished = self._sync(n)
        self._emit_rolling()
        return finished

    def _sync(self, n: int) -> List[_Request]:
        self.decode_syncs += 1
        self._run_syncs += 1
        toks_h = _host_fetch(self._hist[:n])                  # (sync_interval, max_batch)
        self._hist_row.zero_()
        now = time.perf_counter()
        finished: List[_Request] = []
        for slot, r in enumerate(self._slot_req):
            if r is None:
                continue
            for t in range(toks_h.shape[0]):
                tok = int(toks_h[t, slot])
                r.tokens.append(tok)
                self._win_tokens += 1
                if tok == self.eos_id or len(r.tokens) >= r.eff_budget:
                    self._finish(r, now)
                    finished.append(r)
                    break
        if finished:
            # budget completions aren't EOS: fold them into the device done
            # vector in ONE batched write (a host→device copy)
            mask = np.zeros((self.max_batch,), bool)
            mask[[r.slot for r in finished]] = True
            self._done.logical_or_(torch.from_numpy(mask).to(self.device))
        return finished

    def _finish(self, r: _Request, now: float) -> None:
        r.done = True
        r.finished_at = now
        self.results[r.rid] = r
        self._run_completed.append(r)
        self._win_completed.append(r)
        self._slot_req[r.slot] = None
        self._free.append(r.slot)

    def finish_run(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._run_t0, 1e-9)
        m = self._metrics(self._run_completed, dt)
        if self.emitter is not None:
            self.emitter.emit({k: m[k] for k in
                               ("tokens_per_s", "p50_latency_s", "queue_depth", "live_slots")})
        return m

    def drain(self) -> None:
        """Serve everything currently queued under this mode's scheduler
        WITHOUT resetting per-run accounting (open-loop replay primitive)."""
        if self.mode == "gang":
            self._run_gang()
        else:
            while self.queue or self._n_live():
                self.step()

    def run(self, max_new_tokens: Optional[int] = None) -> Dict[str, float]:
        """Serve everything currently queued; returns throughput metrics
        computed over THIS run's completions only."""
        self._begin_run(max_new_tokens)
        self.drain()
        return self.finish_run()

    # ----------------------------------------------------------- gang mode
    def _run_gang(self) -> None:
        """Static-batching baseline: admit a batch, decode until every member
        finishes (or budgets out), sync every token."""
        while self.queue:
            live = [self.queue.popleft()
                    for _ in range(min(self.max_batch, len(self.queue)))]
            width = self._width_of(max(len(r.prompt) for r in live))
            self._run_admission(live, self.max_batch, width, self._all_slots)
            budgets = [self._eff_budget(r, width) for r in live]
            t_host = _host_fetch(self._tok)
            self.decode_syncs += 1
            self._run_syncs += 1
            for i, r in enumerate(live):
                r.tokens.append(int(t_host[i]))
                self._win_tokens += 1
                if r.tokens[-1] == self.eos_id or len(r.tokens) >= budgets[i]:
                    r.done = True
            for _ in range(max(budgets) - 1):
                if all(r.done for r in live):
                    break
                if self._decode_bound is None:
                    self._decode_bound = self.graphs.bind(
                        "serve.decode_step", self._gang_step, self.params, self._tok,
                        self._caches, self._pos)
                self._decode_bound()
                self.decode_steps += 1
                self._run_steps += 1
                t_host = _host_fetch(self._tok)   # the per-token sync the
                self.decode_syncs += 1        # continuous engine amortizes
                self._run_syncs += 1
                for i, r in enumerate(live):
                    if not r.done:
                        nxt = int(t_host[i])
                        r.tokens.append(nxt)
                        self._win_tokens += 1
                        if nxt == self.eos_id or len(r.tokens) >= budgets[i]:
                            r.done = True
            now = time.perf_counter()
            for r in live:                    # gang: nobody leaves early
                r.done = True
                r.finished_at = now
                self.results[r.rid] = r
                self._run_completed.append(r)
                self._win_completed.append(r)
            self._emit_rolling()

    # -------------------------------------------------------------- metrics
    def _metrics(self, completed: List[_Request], dt: float) -> Dict[str, float]:
        total = sum(len(r.tokens) for r in completed)
        lat = [r.finished_at - r.submitted for r in completed]
        return {
            "tokens_per_s": total / dt,
            "p50_latency_s": float(np.median(lat)) if lat else 0.0,
            "p99_latency_s": float(np.percentile(lat, 99)) if lat else 0.0,
            "total_tokens": float(total),
            "completed": float(len(completed)),
            "decode_steps": float(self._run_steps),
            "decode_syncs": float(self._run_syncs),
            "queue_depth": float(len(self.queue)),
            "live_slots": float(self._n_live()),
        }

    def _emit_rolling(self) -> None:
        """Per-window telemetry at the sync boundary: rates cover the tokens
        and completions since the previous sync; gauges are read at the
        boundary.  ``last_window`` keeps the most recent record."""
        now = time.perf_counter()
        lat = [r.finished_at - r.submitted for r in self._win_completed]
        m = {
            "tokens_per_s": self._win_tokens / max(now - self._win_t0, 1e-9),
            "p50_latency_s": float(np.median(lat)) if lat else 0.0,
            "queue_depth": float(len(self.queue)),
            "live_slots": float(self._n_live()),
        }
        self._win_tokens = 0
        self._win_completed = []
        self._win_t0 = now
        self.last_window = m
        if self.emitter is not None:
            self.emitter.emit(m)
