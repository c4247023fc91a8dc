"""The program's own spans, counts and request stamps over the window.

The port records spans (``repro_torch.core.telemetry.span``) while a
profiler records or after ``set_tracing(True)``: ``serve.admit``,
``serve.decode`` and ``serve.sync`` in each server step, ``train.forward``,
``train.backward`` and ``train.optimizer`` in each train step.  Its server
stamps every request with ``admitted_at`` and ``first_token_at``.  The
readers here take the spans that started inside the window, and the stamps
of the requests the window counts (``rec.in_window``).  A program without
the recorder or the stamps reads None, never an error; so does a device
time off the card.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

from .readings import p95_ms


def window_spans(rec, *names: str) -> Optional[list]:
    """The spans named ``names`` that started in the window, by start; None
    where the program keeps no spans."""
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    read = getattr(telemetry, "spans", None)
    if read is None:
        return None
    return sorted((s for s in read(rec.window.t0, rec.window.t1) if s.name in names),
                  key=lambda s: s.t0)


def device_ms(spans: Iterable) -> Optional[float]:
    """Σ device milliseconds of ``spans``; None if any has none (off the card)."""
    ms = [s.device_ms for s in spans]
    return sum(ms) if ms and all(m is not None for m in ms) else None


def counted(spans: Iterable, key: str) -> float:
    return sum(s.counts.get(key, 0) for s in spans)


def decode_step_ms(rec) -> Optional[float]:
    """Device milliseconds of one decode step: Σ ``serve.decode`` device time
    over the decode steps it launched."""
    spans = window_spans(rec, "serve.decode")
    steps = counted(spans, "steps") if spans else 0
    ms = device_ms(spans) if steps else None
    return ms / steps if ms is not None else None


def admissions(rec) -> Optional[list]:
    """The window's ``serve.admit`` spans that prefilled something."""
    spans = window_spans(rec, "serve.admit")
    return [s for s in spans if s.counts.get("padded", 0) > 0] if spans else None


def prefill_ms_per_ktok(rec) -> Optional[float]:
    """Device milliseconds of admission per thousand padded prompt tokens."""
    spans = admissions(rec)
    ms = device_ms(spans) if spans else None
    return ms / (counted(spans, "padded") / 1000.0) if ms is not None else None


def pad_share_pct(rec) -> Optional[float]:
    """Share of the prefilled width that is pad: (padded − kept) / padded, %."""
    spans = admissions(rec)
    if not spans:
        return None
    padded = counted(spans, "padded")
    return 100.0 * (padded - counted(spans, "kept")) / padded


def host_turnarounds(spans: List) -> List[float]:
    """Host seconds from each fetch (``serve.sync``'s ``fetched``) to the next
    step's first launch: its admission's ``launch`` stamp, else the start of
    its ``serve.decode``; ``spans`` in order of start."""
    out, fetched = [], None
    for s in spans:
        if fetched is not None:
            launch = (s.stamps.get("launch") if s.name == "serve.admit"
                      else s.t0 if s.name == "serve.decode" else None)
            if launch is not None:
                out.append(launch - fetched)
                fetched = None
        if s.name == "serve.sync":
            fetched = s.stamps.get("fetched")
    return out


def host_turnaround_ms(rec) -> Optional[float]:
    """Mean host milliseconds between a step's fetch and the next step's
    first launch, over the window's consecutive steps."""
    spans = window_spans(rec, "serve.admit", "serve.decode", "serve.sync")
    gaps = host_turnarounds(spans) if spans else []
    return 1e3 * sum(gaps) / len(gaps) if gaps else None


def stamped(rec) -> Optional[list]:
    """The server's requests behind the window's counted ones; None where the
    server keeps no admission and first-token stamps."""
    reqs = [t.req for t in rec.in_window]
    if not reqs or not all(hasattr(r, "admitted_at") and hasattr(r, "first_token_at")
                           for r in reqs):
        return None
    return reqs


def queue_wait_p95_ms(rec) -> Optional[float]:
    """p95 of the server's own admission stamp − the request's submit stamp
    (its scheduled arrival in an open loop); the drain's end if never
    admitted."""
    reqs = stamped(rec)
    if reqs is None:
        return None
    return p95_ms([(r.admitted_at if r.admitted_at is not None else rec.drain_end) - r.submitted
                   for r in reqs])


def first_sync_wait_p95_ms(rec) -> Optional[float]:
    """p95 over the admitted requests of first token (the fetch that
    delivered it) − admission; the drain's end if no token came."""
    reqs = stamped(rec)
    if reqs is None:
        return None
    return p95_ms([(r.first_token_at if r.first_token_at is not None else rec.drain_end)
                   - r.admitted_at for r in reqs if r.admitted_at is not None])


def train_phase_ms(rec, name: str) -> Optional[float]:
    """Mean device milliseconds of the ``name`` spans per train step."""
    spans = window_spans(rec, name)
    ms = device_ms(spans) if spans and rec.window_steps else None
    return ms / rec.window_steps if ms is not None else None
