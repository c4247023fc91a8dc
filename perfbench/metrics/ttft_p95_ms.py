"""p95 of time to first token over every request that arrived in the window,
from its scheduled arrival."""
from perfbench.lib.readings import p95_ms, ttft_s


def value(rec):
    return p95_ms(ttft_s(rec))
