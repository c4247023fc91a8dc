"""Device milliseconds of one decode step in the window: Σ ``serve.decode``
device time (CUDA events around the server's ``sync_interval`` decode
launches) over the decode steps launched."""
from perfbench.lib.spans import decode_step_ms


def value(rec):
    return decode_step_ms(rec)
