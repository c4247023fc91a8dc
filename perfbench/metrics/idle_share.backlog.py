"""Share of the traced window with no operation running on the device, in %."""
from perfbench.lib.readings import idle_pct


def value(rec):
    return idle_pct(rec)
