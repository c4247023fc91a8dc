"""Model FLOPs of the window's work (each admitted prompt's tokens and each
delivered token's decode step: 2 FLOPs a multiply-add of the matrices a
token meets, attention over its live positions) over the window at the
bf16 peak, in %."""
from perfbench.lib.readings import mfu_pct


def value(rec):
    return mfu_pct(rec.flops, rec.window.seconds)
