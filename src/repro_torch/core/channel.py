"""Low-latency shared-memory channel between the system and the MLOS agent.

The port of ``repro/core/channel.py`` (stdlib only).  A ring this module
creates is named ``rt_<pid>_<random hex>``, so it never collides with a
reference channel (``psm_*``) in the same process or test run.

A single-producer / single-consumer byte ring over
``multiprocessing.shared_memory`` — the paper's "low latency shared memory
communication channel" (§2.1 step 1b).  Two rings form a duplex
:class:`MlosChannel`: telemetry flows system→agent, config updates agent→system.

Layout of one ring (little-endian):

    [0:8)   head  — total bytes ever written (producer-owned)
    [8:16)  tail  — total bytes ever read    (consumer-owned)
    [16:..) data  — power-of-two circular buffer

Records are ``[u32 length][payload]``; a length of 0xFFFFFFFF is a wrap marker
(skip to next buffer start).  Head/tail are monotonically increasing u64s so
the full/empty distinction is trivial and a torn read can only under-estimate
available space/data (safe for SPSC on CPython, whose byte-slice stores are
performed under the GIL / process memory-ordering on x86).
"""
from __future__ import annotations

import os
import secrets
import struct
from multiprocessing import shared_memory
from typing import List, Optional, Sequence

__all__ = ["ShmRing", "MlosChannel"]

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_WRAP = 0xFFFFFFFF
_HDR = 16


class ShmRing:
    """SPSC byte ring over POSIX shared memory."""

    def __init__(self, name: Optional[str] = None, capacity: int = 1 << 20, create: bool = True):
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self.capacity = capacity
        if create:
            name = name or f"rt_{os.getpid()}_{secrets.token_hex(6)}"
            self._shm = shared_memory.SharedMemory(name=name, create=True, size=_HDR + capacity)
            self._shm.buf[:_HDR] = b"\x00" * _HDR
        else:
            self._shm = shared_memory.SharedMemory(name=name, create=False)
            self.capacity = self._shm.size - _HDR
        self.name = self._shm.name
        self._buf = self._shm.buf

    # -- counters -----------------------------------------------------------
    @property
    def head(self) -> int:
        return _U64.unpack_from(self._buf, 0)[0]

    @head.setter
    def head(self, v: int) -> None:
        _U64.pack_into(self._buf, 0, v)

    @property
    def tail(self) -> int:
        return _U64.unpack_from(self._buf, 8)[0]

    @tail.setter
    def tail(self, v: int) -> None:
        _U64.pack_into(self._buf, 8, v)

    # -- producer -----------------------------------------------------------
    def push(self, payload: bytes) -> bool:
        """Append one record; returns False (drops) if the ring is full.

        Dropping telemetry under pressure (rather than blocking the system's
        inner loop) is the paper's explicit design choice.
        """
        return self.push_many((payload,)) == 1

    def _write_record(self, head: int, tail: int, payload: bytes) -> int:
        """Frame one record at the local ``head`` cursor (wrap marker /
        end-of-buffer padding rules shared by every producer path); returns
        the advanced cursor, or -1 if the record does not fit.  The caller
        owns publishing ``self.head``."""
        n = len(payload)
        need = 4 + n
        free = self.capacity - (head - tail)
        pos = head % self.capacity
        tail_room = self.capacity - pos
        if tail_room < 4:
            # Cannot even fit a wrap marker header cleanly; pad to boundary
            # (consumer skips unusable <4-byte tails by the same rule).
            if free < tail_room + need:
                return -1
            head += tail_room
            pos = 0
        elif tail_room < need:
            if free < tail_room + need:
                return -1
            _U32.pack_into(self._buf, _HDR + pos, _WRAP)
            head += tail_room
            pos = 0
        elif free < need:
            return -1
        self._buf[_HDR + pos + 4 : _HDR + pos + 4 + n] = payload
        _U32.pack_into(self._buf, _HDR + pos, n)
        return head + need

    def push_many(self, payloads: Sequence[bytes]) -> int:
        """Batched produce mirroring :meth:`drain`: one head read, local
        cursor arithmetic per record, and a single head publish for the whole
        batch — the consumer sees all-or-progress, never a torn batch, and
        the shared counters are touched twice regardless of batch size.

        Returns how many leading payloads were appended; a full ring drops
        the remainder rather than blocking.  Oversized payloads raise before
        anything is published.
        """
        for p in payloads:
            if 4 + len(p) > self.capacity // 2:
                raise ValueError("payload too large for ring")
        head, tail = self.head, self.tail
        start = head
        sent = 0
        for p in payloads:
            nxt = self._write_record(head, tail, p)
            if nxt < 0:
                break
            head = nxt
            sent += 1
        if head != start:
            self.head = head  # publish once
        return sent

    # -- consumer -----------------------------------------------------------
    def pop(self) -> Optional[bytes]:
        head, tail = self.head, self.tail
        while True:
            if head == tail:
                return None
            pos = tail % self.capacity
            tail_room = self.capacity - pos
            if tail_room < 4:
                tail += tail_room
                continue
            (n,) = _U32.unpack_from(self._buf, _HDR + pos)
            if n == _WRAP:
                tail += tail_room
                continue
            payload = bytes(self._buf[_HDR + pos + 4 : _HDR + pos + 4 + n])
            self.tail = tail + 4 + n
            return payload

    def drain(self, limit: int = 1 << 30) -> List[bytes]:
        """Batched consume: everything available (≤ ``limit`` records) in one
        pass — a single head read and a single tail publish for the whole
        batch, instead of :meth:`pop`'s two shared-counter accesses per
        record.  This is the agent's per-poll path when multiplexing many
        sessions: record cost degrades to a local scan, and the producer sees
        one tail jump.  Wrap markers and end-of-buffer padding are skipped by
        the same rules as :meth:`pop`.
        """
        out: List[bytes] = []
        head, tail = self.head, self.tail
        start_tail = tail
        while tail != head and len(out) < limit:
            pos = tail % self.capacity
            tail_room = self.capacity - pos
            if tail_room < 4:
                tail += tail_room  # unusable padding at buffer end
                continue
            (n,) = _U32.unpack_from(self._buf, _HDR + pos)
            if n == _WRAP:
                tail += tail_room
                continue
            out.append(bytes(self._buf[_HDR + pos + 4 : _HDR + pos + 4 + n]))
            tail += 4 + n
        if tail != start_tail:
            self.tail = tail  # publish once
        return out

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        self._buf = None  # release memoryview before closing (CPython requirement)
        self._shm.close()

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass


class MlosChannel:
    """Duplex channel: telemetry ring (system→agent) + control ring (agent→system)."""

    def __init__(self, telemetry: ShmRing, control: ShmRing, owner: bool):
        self.telemetry = telemetry
        self.control = control
        self._owner = owner

    @classmethod
    def create(cls, capacity: int = 1 << 20) -> "MlosChannel":
        return cls(ShmRing(capacity=capacity), ShmRing(capacity=capacity), owner=True)

    @classmethod
    def attach(cls, telemetry_name: str, control_name: str) -> "MlosChannel":
        return cls(ShmRing(telemetry_name, create=False), ShmRing(control_name, create=False), owner=False)

    @property
    def names(self):
        return (self.telemetry.name, self.control.name)

    def close(self) -> None:
        self.telemetry.close()
        self.control.close()
        if self._owner:
            self.telemetry.unlink()
            self.control.unlink()
