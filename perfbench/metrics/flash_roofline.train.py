"""The flash-attention kernel's share of its roofline in the window's train
steps: every launch (forward and recompute) at the batch's shape."""
from perfbench.lib.readings import flash_roofline_pct
from perfbench.lib.trace import kernel_seconds


def value(rec):
    if rec.trace is None:
        return None
    calls = kernel_seconds(rec.trace, "flash_attention_tc")[1]
    return flash_roofline_pct(rec, [(rec.batch, rec.seq)] * calls)
