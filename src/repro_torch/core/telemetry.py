"""Telemetry: app metrics plus the OS counters and step-registry counters MLOS
gathers around them, packed onto the shared-memory channel.

The port of ``repro/core/telemetry.py``.  The developer supplies only
app-level metrics (the timing of a critical section, a loss); MLOS gathers
the context:

  * :func:`os_counters` reads ``/proc`` (CPU time, RSS, context switches,
    faults) through handles opened once per process;
  * :func:`compile_cache_counters` reads the port's step registry
    (:func:`repro_torch.core.compilecache.cache_counters`).

Both flow through the same :class:`TelemetryEmitter` onto the
shared-memory channel in the packed binary schema of
:mod:`repro_torch.core.codegen`.  The reference's ``hlo_counters`` and
``collective_bytes`` read a compiled XLA program's cost analysis and HLO
text; they have no torch meaning and are not ported.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Sequence

from .channel import MlosChannel
from .codegen import pack_telemetry
from .registry import ComponentMeta

__all__ = ["os_counters", "compile_cache_counters", "TelemetryEmitter", "Stopwatch"]


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


class Stopwatch:
    """Context manager timing a critical section (the app metric of the paper)."""

    def __enter__(self) -> "Stopwatch":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed_s = time.perf_counter() - self.t0


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
