"""Mean host time of one ``BatchedServer.step()`` in the window (admission,
``sync_interval`` decode steps, the host sync)."""
from perfbench.lib.readings import step_ms


def value(rec):
    return step_ms(rec)
