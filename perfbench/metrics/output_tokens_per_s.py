"""Output tokens delivered to the host in the window over its seconds."""
from perfbench.lib.readings import window_steps


def value(rec):
    return sum(s["tokens"] for s in window_steps(rec)) / rec.window.seconds
