"""Device milliseconds of admission per thousand prefilled tokens in the
window: Σ ``serve.admit`` device time (from the first admission launch to
the last's end) over its padded widths / 1000."""
from perfbench.lib.spans import prefill_ms_per_ktok


def value(rec):
    return prefill_ms_per_ktok(rec)
