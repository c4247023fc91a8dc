"""``train_flops`` of every step in the window over the window at the bf16
peak, in %."""
from perfbench.lib.readings import mfu_pct
from perfbench.lib.yardstick import train_flops


def value(rec):
    return mfu_pct(train_flops(rec.model, rec.batch, rec.seq) * rec.window_steps,
                   rec.window.seconds)
