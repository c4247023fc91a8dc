"""Elastic scaling: re-plan the mesh for a changed device count and reshard.

The port of ``repro/runtime/elastic.py``.  On a failure without spares (or
on a capacity grant) a job continues at another world size:
:func:`replan_mesh` re-factorizes the device count into (data, model),
keeping the model axis as close as possible to the old one (the weights'
layouts survive; only the data-parallel degree changes), and
:func:`reshard_state` gives each leaf of a restored checkpoint as this
rank's shard under the new rules (restore-time resharding: the filesystem
is the exchange medium, no migration protocol).  Ranks lie on the mesh in
row-major order over its axes, and a dimension sharded over several axes
splits in the order the axes are named, as a ``PartitionSpec`` splits it.
On a world of one the shard is the whole leaf, moved to the device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..launch.mesh import Mesh
from ..models.layers import P
from ..parallel import sharding as shd

__all__ = ["replan_mesh", "reshard_state", "usable_factorization", "rank_coords"]


def usable_factorization(n_devices: int, prefer_model: int) -> Tuple[int, int]:
    """(data, model) with model | n_devices, model as close to prefer_model
    as possible (never exceeding it), data = n_devices // model."""
    best = 1
    for m in range(1, prefer_model + 1):
        if n_devices % m == 0:
            best = m
    return n_devices // best, best


def replan_mesh(n_devices: int, prefer_model: int = 16) -> Mesh:
    """The (data, model) mesh of ``n_devices`` ranks."""
    data, model = usable_factorization(n_devices, prefer_model)
    return Mesh(f"elastic{n_devices}", (("data", data), ("model", model)))


def rank_coords(mesh: Mesh, rank: int) -> Dict[str, int]:
    """The coordinate of ``rank`` on each axis (row-major over the axes)."""
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} is not on mesh {mesh.name!r} of {mesh.size} devices")
    out: Dict[str, int] = {}
    for axis, n in reversed(mesh.shape):
        out[axis] = rank % n
        rank //= n
    return out


def _shard(x: torch.Tensor, p: P, rules: shd.Rules, mesh: Mesh,
           coords: Dict[str, int]) -> torch.Tensor:
    sizes = mesh.sizes
    for dim, entry in enumerate(shd.spec_for(p, rules, mesh)):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        index, parts = 0, 1
        for a in axes:                          # the first axis named is the outermost split
            index, parts = index * sizes[a] + coords[a], parts * sizes[a]
        step = x.shape[dim] // parts
        x = x.narrow(dim, index * step, step)
    return x


def reshard_state(state: Any, spec_tree: Any, rules: shd.Rules, mesh: Mesh,
                  rank: int = 0, device: Optional[Union[str, torch.device]] = None) -> Any:
    """Every leaf of ``state`` as ``rank``'s shard under (rules, mesh), on
    ``device`` (default: where the leaf is).  ``spec_tree`` has ``state``'s
    structure with a P at every leaf."""
    coords = rank_coords(mesh, rank)

    def put(x: Any, p: Any) -> Any:
        if isinstance(x, dict):
            return {k: put(v, p[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v, pv) for v, pv in zip(x, p))
        out = _shard(x, p, rules, mesh, coords).contiguous()
        return out.to(device) if device is not None else out

    return put(state, spec_tree)
