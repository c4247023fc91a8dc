"""p95 over the window's admitted requests of the fetch that delivered the
first token (``first_token_at``) − admission (``admitted_at``); the
drain's end if no token came."""
from perfbench.lib.spans import first_sync_wait_p95_ms


def value(rec):
    return first_sync_wait_p95_ms(rec)
