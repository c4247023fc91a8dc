"""Process start to the window's start: loading, drawing weights, building and
warming every kernel and graph the window runs."""


def value(rec):
    return rec.setup_s
