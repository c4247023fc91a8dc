"""Faults planted in the program's timed path, to show that the comparison
that decides ``correct`` catches them: each returns the attribute to
replace, as (module, name, replacement)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple


def token_altered() -> Tuple[Any, str, Callable]:
    """Each slot's last token of a sync altered as the server hands it to
    the host."""
    from repro_torch.runtime import serve_loop

    real = serve_loop._host_fetch

    def altered(x):
        out = real(x).copy()
        out[-1] = (out[-1] + 1) % 200 + 2
        return out

    return serve_loop, "_host_fetch", altered


def cache_unchanged() -> Tuple[Any, str, Callable]:
    """A decode step that leaves its cache as it found it."""
    from repro_torch.models import model as M
    from repro_torch.tree import leaves

    real = M.decode_step

    def unchanged(params, cfg, token, caches, pos):
        saved = [t.clone() for t in leaves(caches)]
        out = real(params, cfg, token, caches, pos)
        for t, s in zip(leaves(caches), saved):
            t.copy_(s)
        return out

    return M, "decode_step", unchanged


SERVE: Dict[str, Callable] = {"token_altered": token_altered, "cache_unchanged": cache_unchanged}
