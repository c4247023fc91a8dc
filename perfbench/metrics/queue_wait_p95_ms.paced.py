"""p95 over the window's requests of scheduled arrival → the start of the step
that took the request out of the server's queue (the drain's end if none did)."""
from perfbench.lib.readings import p95_ms


def value(rec):
    return p95_ms([(t.admitted if t.admitted is not None else rec.drain_end) - t.sched
                   for t in rec.in_window])
