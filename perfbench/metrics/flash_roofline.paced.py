"""The flash-attention kernel's share of its roofline in the window's prefills:
one call a layer at each admitted prompt's padded width."""
from perfbench.lib.readings import flash_roofline_pct


def value(rec):
    shapes = [(1, w) for w in rec.prefill_widths for _ in range(rec.model.n_layers)]
    return flash_roofline_pct(rec, shapes)
