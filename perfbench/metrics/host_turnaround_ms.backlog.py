"""Mean host milliseconds from one step's fetch (``serve.sync``) to the next
step's first launch, over the window's consecutive server steps: the time
the device waits for the host between steps."""
from perfbench.lib.spans import host_turnaround_ms


def value(rec):
    return host_turnaround_ms(rec)
