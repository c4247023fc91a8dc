"""p95 of time per output token after the first, over the same requests."""
from perfbench.lib.readings import p95_ms, tpot_s


def value(rec):
    return p95_ms(tpot_s(rec))
