"""Mean device milliseconds of the ``train.optimizer`` spans per train step in the
window (CUDA events at each end of the span)."""
from perfbench.lib.spans import train_phase_ms


def value(rec):
    return train_phase_ms(rec, "train.optimizer")
