"""Mean device time of one train step in the window, by CUDA events recorded
before and after each step."""


def value(rec):
    return sum(rec.step_ms) / len(rec.step_ms) if rec.step_ms else None
