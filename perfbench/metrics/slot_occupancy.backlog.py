"""Mean share of the server's slots live in the window's steps (``live_slots``
before the step plus its admissions, over ``max_batch``), in %."""
from perfbench.lib.readings import window_steps


def value(rec):
    steps = window_steps(rec)
    return 100.0 * sum(s["live"] for s in steps) / (len(steps) * rec.max_batch) if steps else None
