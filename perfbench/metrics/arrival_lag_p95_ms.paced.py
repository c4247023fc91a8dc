"""p95 over the window's requests of submit time − scheduled arrival: how late
the open loop submits, the server taking requests between steps."""
from perfbench.lib.readings import p95_ms


def value(rec):
    return p95_ms([t.submitted - t.sched for t in rec.in_window])
