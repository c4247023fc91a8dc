"""Serving loop: slot-level continuous batching with amortized host sync.

The port of ``repro/runtime/serve_loop.py``.  It serves every family whose
caches :mod:`repro_torch.models.model` builds (dense, moe, ssm, hybrid,
encdec, vlm): the scheduler sees a cache only through ``init_cache`` and
``install_slot``.  An encoder-decoder or a VLM also takes a modal input,
the stubbed frontend's output: as in the reference, zeros of width
``d_model`` in float32, ``num_modal_tokens`` long for a VLM and
``max(2, bucket_pow2(capacity // 4))`` for an encoder-decoder, one length
per server, since every admitted request shares the batched cross
caches.
For MoE, expert capacity couples the rows of a step (every slot routes,
live or not, as in the reference), so a stream depends on its batch and
continuous batching is not a pure reordering of one-at-a-time decoding;
the contract is the reference server's streams for the same requests.  Two
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

Spans (:func:`repro_torch.core.telemetry.span`; one flag check each while
tracing is off): a continuous :meth:`BatchedServer.step` is at most three,
``serve.admit`` (popping, padding, the copies and the admission launches;
its device time starts at the first launch, whose host time it stamps as
``launch``; it counts ``requests``, ``kept`` prompt tokens and ``padded``
widths), ``serve.decode`` (the ``sync_interval`` decode launches, counted
as ``steps``) and ``serve.sync`` (the fetch, stamped as ``fetched``, and
the bookkeeping after it).  Gang mode uses the same names for its
admission (with no ``launch`` stamp), each decode step and each fetch.
Each request keeps two stamps whatever the tracing: ``admitted_at``, when
it left the queue, and ``first_token_at``, the fetch that delivered its
first token.

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

Programs outlive their server, as the reference's compiled steps do ("two
servers over the same (config, capacity, batch) share compiled artifacts
in-process"): when a server is freed, its graphs and the static buffers
they are bound to are handed over (``compilecache.hand_over``) under the
model's identity (the params tree and every leaf's address) and the
server's context (config signature, workload, capacity, ``max_batch``,
``eos_id``, step mode, device).  A later server of that model and context
takes them over and starts from the empty state a new server has (every
slot done, ``tok``/``pos`` and the history zero, the caches zeroed), so its
streams equal a new server's; it captures only the shape classes its
predecessors never ran.  A server built while another of its context is
alive captures its own.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import weakref
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import compilecache
from ..core.compilecache import Graphs, cached_step, config_signature
from ..core.configstore import bucket_pow2
from ..core.registry import MetricSpec, tunable_component
from ..core.telemetry import span
from ..core.tunable import Int
from ..models import model as M
from ..models.config import ModelConfig
from ..tree import leaves

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
def _prefill(params: Dict[str, Any], tokens: torch.Tensor, modal: Optional[torch.Tensor], *,
             cfg: ModelConfig, capacity: int):
    return M.prefill(params, cfg, tokens, capacity, modal)


def _admit(params, tokens, modal, slots, caches, tok, pos, done, *, prefill, install) -> None:
    """Prefill ``tokens`` (with ``modal``) and install its rows into
    ``slots`` of the state."""
    logits, small, width = prefill(params, tokens, modal)
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


class _Static:
    """A server's static buffers and the steps bound to them: what a later
    server of the same model and context takes over.  The steps write the
    buffers in place; nothing rebinds them (a graph replays on the buffers
    it was captured on)."""

    def __init__(self, capture: bool, max_batch: int, device: torch.device):
        self.graphs = Graphs(capture=capture)
        self.admit: Dict[Tuple[int, int], Any] = {}    # (rows, width) -> bound step
        self.decode: Dict[str, Any] = {}               # key -> bound step
        self.caches = None                             # built at the first admission
        self.prompts: Dict[Tuple[int, int], torch.Tensor] = {}
        self.modal: Dict[int, Optional[torch.Tensor]] = {}   # rows -> zero frames
        z = functools.partial(torch.zeros, device=device, dtype=torch.long)
        self.tok, self.pos = z((max_batch,)), z((max_batch,))
        self.done = torch.ones((max_batch,), dtype=torch.bool, device=device)
        self.hist, self.hist_row, self.slot = z((HISTORY, max_batch)), z((1,)), z((1,))
        self.all_slots = torch.arange(max_batch, device=device)

    def reset(self) -> None:
        """A new server's state: every slot done, the registers and the
        history zero, the caches zeroed (an idle slot decodes on them, and
        a MoE step couples it to the live ones)."""
        self.done.fill_(True)
        for t in (self.tok, self.pos, self.hist, self.hist_row):
            t.zero_()
        if self.caches is not None:
            for leaf in leaves(self.caches):
                leaf.zero_()


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
    admitted_at: Optional[float] = None     # popped from the queue (time.perf_counter)
    first_token_at: Optional[float] = None  # the fetch that delivered its first token


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
        # cross caches are shared by every admitted request, so the modal
        # length is fixed per server, not per prompt width (the reference's)
        self._enc_len = cfg.num_modal_tokens or max(2, bucket_pow2(max(1, capacity // 4)))
        self._axes = M.cache_batch_axes(cfg, self.max_batch, capacity, self._enc_len)

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

        # per-slot device state and the steps bound to it, taken over from a
        # finished server of this model and context where there is one
        key = (compilecache.model_identity(params), sig, self.workload, capacity,
               self.max_batch, eos_id, self.step_mode, str(self.device))
        st = compilecache.take_over(key)
        if st is None:
            st = _Static(self.step_mode == "graph", self.max_batch, self.device)
        else:
            st.reset()
        self._st = st
        weakref.finalize(self, compilecache.hand_over, key, st).atexit = False

        self.queue: Deque[_Request] = deque()
        self.results: Dict[int, _Request] = {}
        self._next_rid = 0
        self._slot_req: List[Optional[_Request]] = [None] * self.max_batch
        self._free: List[int] = list(range(self.max_batch))
        self.decode_steps = 0               # lifetime counters
        self.decode_syncs = 0
        self.prefill_calls = 0
        self.prefill_captures = 0           # admission programs this server captured
        self._begin_run(None)

    # ------------------------------------------------- the static state
    @property
    def graphs(self) -> Graphs:
        return self._st.graphs

    @graphs.setter
    def graphs(self, graphs: Graphs) -> None:
        """Run the steps through ``graphs`` from now on (bound anew)."""
        self._st.graphs = graphs
        self._st.admit.clear()
        self._st.decode.clear()

    @property
    def _caches(self) -> Any:
        return self._st.caches

    @property
    def _hist(self) -> torch.Tensor:
        return self._st.hist

    @property
    def _hist_row(self) -> torch.Tensor:
        return self._st.hist_row

    @property
    def _admit_steps(self) -> Dict[Tuple[int, int], Any]:
        return self._st.admit

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
        """Left-pad (token 0) each prompt's tail into a (rows, width) host
        tensor, pinned on CUDA so that the copy to the device does not
        block."""
        toks = np.zeros((rows, width), np.int64)
        for i, r in enumerate(reqs):
            n = min(len(r.prompt), width)
            if n:
                toks[i, -n:] = r.prompt[-n:]  # left-pad; keep the prompt tail
        host = torch.from_numpy(toks)
        return host.pin_memory() if self.device.type == "cuda" else host

    def _eff_budget(self, r: _Request, width: int) -> int:
        b = r.budget or self._budget_override or self.max_new_tokens
        if not self.cfg.window:
            b = min(b, self.capacity - width)  # full cache must not wrap
        return max(1, b)

    def _modal(self, rows: int) -> Optional[torch.Tensor]:
        """The stubbed frontend's frames for ``rows`` prompts (encdec, vlm):
        zeros (rows, enc_len, d_model) in float32, one static buffer a row
        count; None for the other families."""
        st = self._st
        if rows not in st.modal:
            st.modal[rows] = (torch.zeros((rows, self._enc_len, self.cfg.d_model),
                                          dtype=torch.float32, device=self.device)
                              if self.cfg.family in ("encdec", "vlm") else None)
        return st.modal[rows]

    def _run_admission(self, host: torch.Tensor, slots: torch.Tensor) -> None:
        """One admission program: prefill the padded prompts ``host`` (rows,
        width; :meth:`_pad_prompts`) and install row i into ``slots[i]`` of
        the state."""
        rows, width = host.shape
        st = self._st
        if st.caches is None:
            st.caches = M.init_cache(self.cfg, self.max_batch, self.capacity, self._enc_len,
                                     device=self.device)
        key = (rows, width)
        prompts = st.prompts.get(key)
        if prompts is None:
            prompts = st.prompts[key] = torch.zeros((rows, width), dtype=torch.long,
                                                    device=self.device)
        prompts.copy_(host.to(self.device, non_blocking=True))
        bound = st.admit.get(key)
        if bound is None:
            bound = st.admit[key] = st.graphs.bind(
                "serve.prefill", self._admit_fn, self.params, prompts, self._modal(rows), slots,
                st.caches, st.tok, st.pos, st.done)
        self.prefill_captures += bound.capture and bound.graph is None
        bound()
        self.prefill_calls += 1

    def _admit(self) -> int:
        """Prefill waiting requests into free slots; bounded per step by the
        ``admission`` count and the ``prefill_chunk`` width budget.  The
        ``serve.admit`` span counts the requests, their kept prompt tokens
        and the padded widths prefilled."""
        admitted, kept, padded = 0, 0, 0
        with span("serve.admit", self.device) as sp:
            while self._free and self.queue and admitted < self.admission:
                width = self._width_of(len(self.queue[0].prompt))
                if admitted and padded + width > self.prefill_chunk:
                    break                        # chunk full; never starves (>=1 admitted)
                r = self.queue.popleft()
                r.admitted_at = time.perf_counter()
                admitted += 1
                kept += min(len(r.prompt), width)
                padded += width
                self._free.sort()
                slot = self._free.pop(0)
                host = self._pad_prompts([r], 1, width)
                sp.mark_launch()
                self._prefill_into(slot, r, host)
            sp.count(requests=admitted, kept=kept, padded=padded)
        return admitted

    def _prefill_into(self, slot: int, r: _Request, host: torch.Tensor) -> None:
        # install IN PLACE: the slot's cache rows and (tok, pos, done)
        # registers.  The first token stays on device: it flows into the
        # decode stream and reaches the host with the next batched sync.
        self._st.slot.fill_(slot)
        self._run_admission(host, self._st.slot)
        r.slot = slot
        r.eff_budget = self._eff_budget(r, host.shape[1])
        self._slot_req[slot] = r

    def _bound_decode(self, key: str) -> Any:
        """The decode step ``key`` (fused or gang) bound to the state."""
        st = self._st
        bound = st.decode.get(key)
        if bound is None:
            if key == "serve.decode_fused":
                args = (self._fused_step, self.params, st.tok, st.caches, st.pos, st.done,
                        st.hist, st.hist_row)
            else:
                args = (self._gang_step, self.params, st.tok, st.caches, st.pos)
            bound = st.decode[key] = st.graphs.bind(key, *args)
        return bound

    def _decode(self) -> None:
        """One fused decode step over every slot; EOS tracking stays on device."""
        self._bound_decode("serve.decode_fused")()

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
        with span("serve.decode", self.device, steps=n):
            for _ in range(n):
                # each step CONSUMES the tok register and records it in the history, so
                # the history's rows are exactly the generated-token stream, the
                # prefill's first token included, with no extra host reads
                self._decode()
                self.decode_steps += 1
                self._run_steps += 1
        with span("serve.sync", self.device) as sp:
            finished, fetched = self._sync(n)
            sp.stamp("fetched", fetched)
            self._emit_rolling()
        return finished

    def _sync(self, n: int) -> Tuple[List[_Request], float]:
        """Read the last ``n`` decode steps' tokens back and finish requests;
        returns those and the moment the tokens reached the host."""
        self.decode_syncs += 1
        self._run_syncs += 1
        toks_h = _host_fetch(self._st.hist[:n])                # (sync_interval, max_batch)
        now = time.perf_counter()
        self._st.hist_row.zero_()
        finished: List[_Request] = []
        for slot, r in enumerate(self._slot_req):
            if r is None:
                continue
            if r.first_token_at is None:
                r.first_token_at = now
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
            self._st.done.logical_or_(torch.from_numpy(mask).to(self.device))
        return finished, now

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
            with span("serve.admit", self.device) as sp:
                live = [self.queue.popleft()
                        for _ in range(min(self.max_batch, len(self.queue)))]
                now = time.perf_counter()
                for r in live:
                    r.admitted_at = now
                width = self._width_of(max(len(r.prompt) for r in live))
                self._run_admission(self._pad_prompts(live, self.max_batch, width),
                                    self._st.all_slots)
                budgets = [self._eff_budget(r, width) for r in live]
                sp.count(requests=len(live), kept=sum(min(len(r.prompt), width) for r in live),
                         padded=self.max_batch * width)
            with span("serve.sync", self.device) as sp:
                t_host, now = self._gang_fetch()
                sp.stamp("fetched", now)
                for i, r in enumerate(live):
                    r.first_token_at = now
                    r.tokens.append(int(t_host[i]))
                    self._win_tokens += 1
                    if r.tokens[-1] == self.eos_id or len(r.tokens) >= budgets[i]:
                        r.done = True
            for _ in range(max(budgets) - 1):
                if all(r.done for r in live):
                    break
                with span("serve.decode", self.device, steps=1):
                    self._bound_decode("serve.decode_step")()
                    self.decode_steps += 1
                    self._run_steps += 1
                with span("serve.sync", self.device) as sp:
                    t_host, now = self._gang_fetch()   # the per-token sync the
                    sp.stamp("fetched", now)           # continuous engine amortizes
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

    def _gang_fetch(self) -> Tuple[np.ndarray, float]:
        """Gang mode's read of every row's token, and the moment it reached
        the host."""
        t_host = _host_fetch(self._st.tok)
        now = time.perf_counter()
        self.decode_syncs += 1
        self._run_syncs += 1
        return t_host, now

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
