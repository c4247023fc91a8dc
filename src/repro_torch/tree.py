"""Nested dict/list trees of tensors: the port's stand-in for ``jax.tree``.

The port's parameters, optimizer moments and train state are plain nested
dicts with lists (``blocks``: one dict per layer).  Leaves are visited in
the order ``jax.tree`` visits them: dict keys sorted, list items by index.
A leaf's path is its keys joined by ``"/"`` (``params/blocks/3/attn/wq``),
the key the checkpoint files store it under.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["SEP", "leaves", "leaves_with_paths", "tree_map", "tree_map_with_path"]

SEP = "/"


def _children(tree: Any):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def leaves_with_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree`` order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from leaves_with_paths(v, f"{prefix}{SEP}{k}" if prefix else k)


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same positions of ``rest``
    (trees of the same structure), called in :func:`leaves` order; the
    structure of ``tree`` is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``; the structure is kept."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [tree_map_with_path(fn, v, f"{prefix}{SEP}{k}" if prefix else k) for k, v in kids]
    if isinstance(tree, dict):
        return {k: out[i] for i, k in enumerate(sorted(tree))}
    return type(tree)(out)
