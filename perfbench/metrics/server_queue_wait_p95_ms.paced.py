"""p95 over the window's requests of the server's own admission stamp
(``admitted_at``) − the scheduled arrival it was submitted with; the
drain's end if never admitted."""
from perfbench.lib.spans import queue_wait_p95_ms


def value(rec):
    return queue_wait_p95_ms(rec)
