"""Share of the window's prefilled width that is pad, in %: (Σ padded − Σ
kept prompt tokens) / Σ padded, from the ``serve.admit`` counts."""
from perfbench.lib.spans import pad_share_pct


def value(rec):
    return pad_share_pct(rec)
