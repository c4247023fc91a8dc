"""Quantities the metric readers share, worked out from a run's record."""
from __future__ import annotations

from typing import List, Optional

from .stats import percentile
from .trace import kernel_seconds
from .yardstick import PEAK_BF16, attention_work, bound_s


def window_steps(rec) -> List[dict]:
    return [s for s in rec.steps if s["window"]]


def ttft_s(rec) -> List[float]:
    """Time to first token of every request that arrived in the window: from
    its scheduled arrival to the step that delivered its first token (the
    drain's end where none came)."""
    return [(t.first if t.first is not None else rec.drain_end) - t.sched for t in rec.in_window]


def tpot_s(rec) -> List[float]:
    """Time per output token after the first of the same requests: (last
    token's step − first token's step) / (tokens − 1); a request still
    streaming at the drain's end takes that end as its last; one with no
    token counts as its whole wait."""
    out = []
    for t in rec.in_window:
        if t.first is None:
            out.append(rec.drain_end - t.sched)
        else:
            end = t.last if t.done else rec.drain_end
            out.append((end - t.first) / max(t.n - 1, 1))
    return out


def p95_ms(values: List[float]) -> Optional[float]:
    return 1e3 * percentile(values, 95) if values else None


def step_ms(rec) -> Optional[float]:
    """Mean host time of the window's server steps (each ends in a sync)."""
    steps = window_steps(rec)
    return 1e3 * sum(s["t1"] - s["t0"] for s in steps) / len(steps) if steps else None


def idle_pct(rec) -> Optional[float]:
    if rec.trace is None or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])


def mfu_pct(flops: float, seconds: float) -> Optional[float]:
    return 100.0 * flops / (seconds * PEAK_BF16) if flops > 0 and seconds > 0 else None


def flash_roofline_pct(rec, shapes: List[tuple]) -> Optional[float]:
    """The flash-attention kernel's share of its roofline: the bound of every
    call (``shapes``: (B, S) per call; bf16 q, k, v, o at the model's
    heads) over the kernel's device time in the trace."""
    if rec.trace is None or not shapes:
        return None
    seconds, calls = kernel_seconds(rec.trace, "flash_attention_tc")
    if calls != len(shapes) or seconds <= 0:
        return None
    m = rec.model
    bound = sum(bound_s(*attention_work(b, s, m.n_heads, m.n_kv_heads, m.hd, 2, m.window))
                for b, s in shapes)
    return 100.0 * bound / seconds
