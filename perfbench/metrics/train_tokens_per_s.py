"""Tokens of every train step completed in the window over its seconds."""


def value(rec):
    return rec.window_steps * rec.tokens_per_step / rec.window.seconds
