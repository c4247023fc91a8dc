"""Telemetry: app metrics plus the OS counters and step-registry counters MLOS
gathers around them, packed onto the shared-memory channel.

The port of ``repro/core/telemetry.py``.  The developer supplies only
app-level metrics (the timing of a critical section, a loss); MLOS gathers
the context:

  * :func:`os_counters` reads ``/proc`` (CPU time, RSS, context switches,
    faults) through handles opened once per process;
  * :func:`compile_cache_counters` reads the port's step registry
    (:func:`repro_torch.core.compilecache.cache_counters`);
  * :func:`op_counters`, the twin of the reference's ``hlo_counters`` and
    ``collective_bytes``: the "HW counters" of one call of a step, traced on
    ``meta`` tensors (shapes and dtypes, no data, no byte allocated), so a
    full-size cell is counted on the host.  The reference reads a compiled
    XLA program's cost analysis and HLO text; the port counts the aten ops
    the call dispatches.

The first two flow through the same :class:`TelemetryEmitter` onto the
shared-memory channel in the packed binary schema of
:mod:`repro_torch.core.codegen`.

Spans say where a step's time goes inside the program: :func:`span` names a
stretch (``serve.admit``, ``serve.decode``, ``serve.sync`` in the server;
``train.forward``, ``train.backward``, ``train.optimizer`` in the train
step) and counts the work done in it.  Tracing is on while a
``torch.profiler`` session records (each span then also enters
``record_function``, so the device trace names what the host was doing) or
after :func:`set_tracing`; otherwise a span is one flag check.  Finished
spans wait in a bounded in-memory store; :func:`spans` reads those of an
interval of host time, and a span's device time is resolved when read.
"""
from __future__ import annotations

import functools
import itertools
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

from .channel import MlosChannel
from .codegen import pack_telemetry
from .registry import ComponentMeta

__all__ = ["os_counters", "compile_cache_counters", "op_counters", "TelemetryEmitter",
           "span", "spans", "set_tracing", "clear_spans", "profiler_recording", "spans_dropped",
           "Span", "NO_SPAN"]


def compile_cache_counters() -> Dict[str, float]:
    """Step-registry telemetry (:mod:`repro_torch.core.compilecache`): hits,
    misses, live entries, build seconds, graph captures and replays.  A
    lazy import: the registry imports torch, and this module does not."""
    from .compilecache import cache_counters

    return cache_counters()


_PAGE = os.sysconf("SC_PAGE_SIZE")
_CLK = os.sysconf("SC_CLK_TCK")


class _ProcReader:
    """Open ``/proc/<pid>/{stat,status}`` once; ``seek(0)`` + read per sample.

    procfs regenerates content on read-after-rewind, so keeping the file
    objects alive turns every sample into two reads instead of two
    open/read/close round-trips.
    """

    __slots__ = ("stat", "status")

    def __init__(self, pid: str):
        self.stat = open(f"/proc/{pid}/stat", "rb")
        self.status = open(f"/proc/{pid}/status", "rb")

    def close(self) -> None:
        for f in (self.stat, self.status):
            try:
                f.close()
            except OSError:  # pragma: no cover
                pass


_PROC_READERS: Dict[str, _ProcReader] = {}
_PROC_READERS_PID = os.getpid()


def _proc_reader(pid: str) -> Optional[_ProcReader]:
    global _PROC_READERS_PID
    if os.getpid() != _PROC_READERS_PID:
        # fork()ed child: inherited fds are bound to the PARENT's /proc files
        # and would silently report its counters — drop and reopen.
        _PROC_READERS.clear()
        _PROC_READERS_PID = os.getpid()
    r = _PROC_READERS.get(pid)
    if r is None:
        try:
            r = _PROC_READERS[pid] = _ProcReader(pid)
        except OSError:  # pragma: no cover - /proc always present on target
            return None
    return r


def os_counters(pid: str = "self") -> Dict[str, float]:
    """CPU/memory/scheduler counters from /proc — cheap enough for inner loops."""
    out: Dict[str, float] = {}
    for _attempt in range(2):  # second pass reopens if the handles went stale
        r = _proc_reader(pid)
        if r is None:
            return out
        try:
            r.stat.seek(0)
            fields = r.stat.read().rsplit(b")", 1)[1].split()
            # fields are offset by 2 relative to proc(5) numbering after the comm strip
            out["utime_s"] = int(fields[11]) / _CLK
            out["stime_s"] = int(fields[12]) / _CLK
            out["minflt"] = float(int(fields[7]))
            out["majflt"] = float(int(fields[9]))
            out["rss_bytes"] = float(int(fields[21]) * _PAGE)
            r.status.seek(0)
            for line in r.status:
                if line.startswith(b"voluntary_ctxt_switches"):
                    out["vctx"] = float(line.split()[1])
                elif line.startswith(b"nonvoluntary_ctxt_switches"):
                    out["nvctx"] = float(line.split()[1])
            return out
        except (OSError, IndexError, ValueError):  # pragma: no cover - stale pid
            _PROC_READERS.pop(pid, None)
            r.close()
    return out


COLLECTIVE_KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all")


def _collective_kind(name: str) -> Optional[str]:
    """The kind of a collective op by its name (``all_gather_into_tensor`` →
    ``all_gather``, DTensor's ``shard_dim_alltoall`` → ``all_to_all``), None
    for what moves no data (``wait_tensor``)."""
    for kind in COLLECTIVE_KINDS:
        if kind in name or kind.replace("_", "") in name:
            return kind
    return "broadcast" if name.startswith("broadcast") else None


@functools.lru_cache(maxsize=1)
def _counting_mode():
    """The dispatch mode behind :func:`op_counters` (defined at first use:
    this module imports no torch)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    aten = torch.ops.aten
    same_storage = (aten._unsafe_view, aten.lift_fresh)      # alias without a view schema
    plain = (torch.Tensor, torch.nn.Parameter)

    def tensor_bytes(t: "torch.Tensor") -> int:
        return t.numel() * t.element_size()

    class Counting(TorchDispatchMode):
        """bytes_accessed: every op's tensor operands and results, read or
        written once each, views (and ops that only alias) as zero;
        collective_bytes: the results of c10d ops, by kind and by the mesh
        axes of their group; live storage bytes, each storage counted once
        from its first appearance until it is freed, and their peak.

        In a DTensor program it counts one rank's local program: an op on
        DTensors is handed back (``NotImplemented``) to DTensor's dispatch,
        which runs the op on the local shards (and any redistribution's
        collectives) through this mode again as plain ops; the sharding
        propagation's own ops on global-shape fake tensors are run and not
        counted.  ``flop_registry`` (``FlopCounterMode``'s formulas) then
        counts the local products' FLOPs here."""

        def __init__(self, flop_registry=None, group_axes=None):
            super().__init__()
            self.ops = 0
            self.flops = 0
            self.flop_registry = flop_registry
            self.group_axes = group_axes or {}
            self.bytes_accessed = 0
            self.collective_bytes = 0
            self.collectives: Dict[str, Dict[str, Any]] = {}
            self.live: Dict[int, tuple] = {}      # storage cdata -> (weak ref, nbytes)
            self.cur = self.peak = 0

        def storage_of(self, t: "torch.Tensor"):
            try:
                return t.untyped_storage()
            except (RuntimeError, NotImplementedError):   # no storage: nothing allocated
                return None

        def track(self, t: "torch.Tensor") -> bool:
            """Count ``t``'s storage if it is new; whether it was."""
            st = self.storage_of(t)
            if st is None:
                return False
            key = st._cdata
            seen = self.live.get(key)
            if seen is not None and not seen[0].expired():
                return False
            if seen is not None:                          # a freed storage's address reused
                self.cur -= seen[1]
            self.live[key] = (StorageWeakRef(st), st.nbytes())
            self.cur += st.nbytes()
            if self.cur > self.peak:                      # a new peak only if nothing freed
                for k, (ref, n) in list(self.live.items()):
                    if ref.expired():
                        del self.live[k]
                        self.cur -= n
                self.peak = max(self.peak, self.cur)
            return True

        def alias(self, src: "torch.Tensor", dst: "torch.Tensor") -> None:
            """``dst`` is ``src``'s data (a collective's wait or autograd wrap:
            on the card the same storage; on ``meta`` a new one, which takes
            over ``src``'s bytes here instead of adding its own)."""
            a, b = self.storage_of(src), self.storage_of(dst)
            if a is None or b is None or a._cdata == b._cdata:
                return
            ref, n = self.live.get(a._cdata, (None, 0))
            if ref is None or ref.expired():
                self.track(dst)
                return
            self.live[a._cdata] = (ref, 0)
            self.live[b._cdata] = (StorageWeakRef(b), n)

        def collective(self, func, args, outs) -> None:
            kind = _collective_kind(func.overloadpacket.__name__.lstrip("_"))
            if kind is None:
                return
            n = sum(tensor_bytes(t) for t in outs)
            self.collective_bytes += n
            entry = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0, "axes": {}})
            entry["count"] += 1
            entry["bytes"] += n
            axes = "+".join(self.group_axes.get(a, "?") for a in tree_leaves(args)
                            if isinstance(a, str) and a in self.group_axes) or "?"
            entry["axes"][axes] = entry["axes"].get(axes, 0.0) + n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(t not in plain for t in types):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented             # DTensor runs it on the shards
                return func(*args, **kwargs)          # fake tensors: not this rank's work
            if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
                return func(*args, **kwargs)          # a fake mode's factory, the same
            out = func(*args, **kwargs)
            self.ops += 1
            if func.namespace == "_c10d_functional" and \
                    func.overloadpacket.__name__ in ("wait_tensor", "_wrap_tensor_autograd"):
                self.alias(args[0], out)
                return out
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            if func.namespace in ("c10d", "_c10d_functional", "_dtensor"):
                self.collective(func, args, outs)
            elif func.overloadpacket is aten.embedding:       # reads the rows it gathers
                self.bytes_accessed += tensor_bytes(args[1]) + 2 * tensor_bytes(out)
            elif not (func.is_view or func.overloadpacket in same_storage):
                ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
                self.bytes_accessed += sum(tensor_bytes(t) for t in ins + outs)
            if self.flop_registry is not None and func.overloadpacket in self.flop_registry:
                self.flops += self.flop_registry[func.overloadpacket](*args, **kwargs,
                                                                      out_val=out)
            for t in outs:
                self.track(t)
            return out

    return Counting


def _local(t: Any) -> Any:
    """A DTensor's local shard; any other tensor itself."""
    local = getattr(t, "_local_tensor", None)
    return local if local is not None else t


def op_counters(fn: Any, *args: Any, device_mesh: Any = None, **kwargs: Any) -> Dict[str, Any]:
    """Counters of one call ``fn(*args, **kwargs)``, run on ``meta`` tensors
    (the arguments' tensors must be ``meta``, or DTensors of ``meta``
    shards; nothing is allocated):

      * ``flops`` — ``torch.utils.flop_counter.FlopCounterMode``: the
        products and convolutions it has formulas for (XLA's count adds
        elementwise and transcendental operations);
      * ``bytes_accessed`` — over the aten ops the call dispatches, their
        tensor operands' and results' bytes, views counted as zero (an
        embedding lookup reads the rows it gathers, not its whole table);
      * ``collective_bytes`` — the bytes the call's collectives return, and
        ``collectives``: per kind (``all_gather``, ``reduce_scatter``,
        ``all_reduce``, ``all_to_all``) their count, bytes and bytes by the
        mesh axes of the group (named from ``device_mesh``);
      * ``argument_bytes``, ``output_bytes``, ``alias_bytes`` — the
        arguments' storages, the results' new storages, the results that
        are argument storages (written in place);
      * ``peak_bytes`` — the most bytes of live storage at once, arguments
        included (each storage counted once from its creation until it is
        freed); ``temp_bytes`` = peak − arguments;
      * ``ops`` — the aten ops dispatched.

    With DTensor arguments (a sharded program, inside a process group of the
    mesh's size) every counter is rank 0's local program: its shards, its
    local ops' FLOPs and bytes, its collectives; never the DTensor-level
    global ops (``FlopCounterMode`` would count the whole program's
    products there, so the FLOPs come from its formulas on the local ops)."""
    import torch
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    leaves_in = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    sharded = any(_local(t) is not t for t in leaves_in)
    group_axes = {}
    if device_mesh is not None:
        group_axes = {device_mesh.get_group(name).group_name: name
                      for name in device_mesh.mesh_dim_names}
    counting = _counting_mode()(FlopCounterMode().flop_registry if sharded else None,
                                group_axes)
    arg_tensors = [_local(t) for t in leaves_in]
    for t in arg_tensors:
        if t.device.type != "meta":
            raise ValueError(f"op_counters traces meta tensors; got one on {t.device}")
        counting.track(t)
    argument = counting.cur
    arg_keys = {st._cdata for st in map(counting.storage_of, arg_tensors) if st is not None}
    if sharded:
        with counting:
            out = fn(*args, **kwargs)
        flops = counting.flops
    else:
        with FlopCounterMode(display=False) as counter, counting:
            out = fn(*args, **kwargs)
        flops = counter.get_total_flops()
    outs = {st._cdata: st.nbytes() for st in
            (counting.storage_of(_local(t)) for t in tree_leaves(out)
             if isinstance(t, torch.Tensor)) if st is not None}
    return {"flops": float(flops),
            "bytes_accessed": float(counting.bytes_accessed),
            "collective_bytes": float(counting.collective_bytes),
            "collectives": counting.collectives,
            "argument_bytes": float(argument),
            "output_bytes": float(sum(n for k, n in outs.items() if k not in arg_keys)),
            "alias_bytes": float(sum(n for k, n in outs.items() if k in arg_keys)),
            "peak_bytes": float(counting.peak),
            "temp_bytes": float(counting.peak - argument),
            "ops": float(counting.ops)}


# =============================================================================
# Spans: where the program's host and device time goes
# =============================================================================
SPAN_CAPACITY = 1 << 14          # finished spans the store keeps; the oldest go first


def profiler_recording() -> bool:
    """Whether a ``torch.profiler`` session records now: torch's own flag,
    read without importing torch (no profiler runs before torch is loaded)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _cuda_event(device: Any) -> Any:
    """A timing event recorded now on CUDA ``device``'s current stream; None
    while the current stream is capturing a graph."""
    torch = sys.modules["torch"]
    if torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Span:
    """One stretch of the program, made by :func:`span` while tracing is on:
    its ``name``, ``id``, the ``parent`` span's id (0 at the top of its
    thread), host start and end ``t0``/``t1`` on ``time.perf_counter``,
    ``counts`` of the work done in it and ``stamps``, host times of named
    moments inside it.  For work on a CUDA ``device`` it records an event at
    each end on that device's current stream; :attr:`device_ms` is the
    device time between them.
    While a profiler records it is also a ``record_function`` range, so it
    sits on the device trace's own clock."""

    __slots__ = ("name", "id", "parent", "t0", "t1", "counts", "stamps", "_device", "_events",
                 "_ms", "_annotation")

    def __init__(self, name: str, device: Any, counts: Dict[str, float]):
        self.name, self.counts = name, counts
        self._device = device if device is not None and device.type == "cuda" else None
        self.id = next(_SPAN_IDS)
        self.parent = 0
        self.t0 = self.t1 = 0.0
        self.stamps: Dict[str, float] = {}
        self._events: Optional[List[Any]] = None
        self._ms: Optional[float] = None
        self._annotation: Any = None

    def __enter__(self) -> "Span":
        stack = _open_spans()
        self.parent = stack[-1].id if stack else 0
        stack.append(self)
        if profiler_recording():
            self._annotation = sys.modules["torch"].profiler.record_function(self.name)
            self._annotation.__enter__()
        self.t0 = time.perf_counter()
        start = None if self._device is None else _cuda_event(self._device)
        self._events = None if start is None else [start, None]
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._events is not None:
            self._events[1] = _cuda_event(self._device)
        self.t1 = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _open_spans().pop()
        _STORE.keep(self)

    def count(self, **counts: float) -> None:
        """Add ``counts`` to the span's."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def stamp(self, key: str, t: float) -> None:
        """Keep host time ``t`` under ``key``."""
        self.stamps[key] = t

    def mark_launch(self) -> None:
        """The span's first device launch comes next.  At the first call the
        host time is stamped as ``launch`` and the device time restarts here,
        so host work before it (while the device may idle) is left out."""
        if "launch" in self.stamps:
            return
        self.stamps["launch"] = time.perf_counter()
        if self._events is not None:
            start = _cuda_event(self._device)
            if start is not None:
                self._events[0] = start

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds on the device between the span's two events (waits
        for the second); None for work off CUDA, or where an end fell in a
        capture."""
        if self._ms is None and self._events is not None and self._events[1] is not None:
            start, end = self._events
            end.synchronize()
            self._ms = start.elapsed_time(end)
            self._events = None
        return self._ms


class _NoSpan:
    """What :func:`span` returns while tracing is off: every call does nothing."""

    __slots__ = ()
    device_ms = None

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def count(self, **counts: float) -> None:
        return None

    def stamp(self, key: str, t: float) -> None:
        return None

    def mark_launch(self) -> None:
        return None


NO_SPAN = _NoSpan()


class SpanStore:
    """The finished spans, at most ``capacity``: a full store lets its oldest
    span go and counts it in ``dropped``."""

    def __init__(self, capacity: int):
        self._spans: Deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def keep(self, s: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(s)

    def between(self, since: Optional[float], until: Optional[float]) -> List[Span]:
        with self._lock:
            return [s for s in self._spans if (since is None or s.t0 >= since)
                    and (until is None or s.t0 < until)]


_TRACING = False                 # set_tracing(True): record without a profiler too
_STORE = SpanStore(SPAN_CAPACITY)
_SPAN_IDS = itertools.count(1)
_LOCAL = threading.local()


def _open_spans() -> List[Span]:
    """This thread's open spans, innermost last."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def set_tracing(on: bool) -> None:
    """Record spans always (``on``), or only while a profiler records (the
    default)."""
    global _TRACING
    _TRACING = bool(on)


def clear_spans() -> None:
    """Empty the store of finished spans and its dropped count."""
    global _STORE
    _STORE = SpanStore(SPAN_CAPACITY)


def span(name: str, device: Any = None, **counts: float) -> Any:
    """A context manager around one stretch of the program (see
    :class:`Span`) whose work goes to ``device`` (a ``torch.device``; device
    time is kept for CUDA alone), starting from ``counts``.  While tracing
    is off it costs one flag check and returns a shared object that does
    nothing."""
    if not _TRACING and not profiler_recording():
        return NO_SPAN
    return Span(name, device, counts)


def spans(since: Optional[float] = None, until: Optional[float] = None) -> List[Span]:
    """The finished spans kept that started in ``[since, until)`` on
    ``time.perf_counter``, in the order they finished."""
    return _STORE.between(since, until)


def spans_dropped() -> int:
    """Finished spans the store let go since it was last emptied."""
    return _STORE.dropped


class TelemetryEmitter:
    """Binds a component instance to the channel; emits packed telemetry.
    A full ring drops the record (counted in ``dropped``) rather than
    blocking the emitting loop."""

    def __init__(self, meta: ComponentMeta, channel: MlosChannel, instance_id: int = 0):
        self.meta = meta
        self.channel = channel
        self.instance_id = instance_id
        self.dropped = 0

    def emit(self, metrics: Dict[str, Any]) -> bool:
        payload = pack_telemetry(self.meta, self.instance_id, metrics)
        ok = self.channel.telemetry.push(payload)
        if not ok:
            self.dropped += 1
        return ok

    def emit_many(self, metrics_seq: Sequence[Dict[str, Any]]) -> int:
        """Flush a batch of samples with one shared-counter round-trip
        (:meth:`ShmRing.push_many`) instead of head-read + head-publish per
        record; returns how many were accepted (the rest count as dropped)."""
        payloads: List[bytes] = [
            pack_telemetry(self.meta, self.instance_id, m) for m in metrics_seq]
        sent = self.channel.telemetry.push_many(payloads)
        self.dropped += len(payloads) - sent
        return sent
