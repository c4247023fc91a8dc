"""Logical-axis sharding: rules tables + divisibility-aware resolution.

The port of ``repro/parallel/sharding.py``.  Every parameter, state and
cache leaf carries *logical* axis names (:class:`repro_torch.models.layers.P`).
A rules table maps each logical axis to an ordered list of mesh-axis
candidates; :func:`spec_for` resolves, per tensor, each dimension's mesh
axes by picking, left to right, the first candidate whose mesh axes are
(a) not already used by an earlier dimension of the same tensor and (b)
divide the dimension evenly.  The result is what the reference's
``PartitionSpec`` holds: per dimension ``None``, one axis name, or a tuple
of names sharded together.  One mechanism gives FSDP+TP+SP for training,
1D/2D-TP and sequence-sharded KV caches for serving, and per-architecture
fallbacks (mixtral's 8 experts do not divide a 16-way model axis, so the
expert dim replicates and the expert-ff dim takes the model axis).

A mesh here is :class:`repro_torch.launch.mesh.Mesh`, a table of axis
sizes; nothing touches a device.  :func:`local_shape` and
:func:`local_bytes` give one device's shard.  On the port's one card
(``one``: every axis of size 1) nothing is sharded, and :func:`constrain`
is the identity: the port runs a tensor whole where the reference would
pin its layout for XLA's partitioner.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from ..launch.mesh import Mesh
from ..models.layers import P

__all__ = [
    "Rules", "TRAIN_RULES", "SERVE_RULES", "train_rules", "serve_rules", "spec_for",
    "local_shape", "local_bytes", "tree_shardings", "tree_local_bytes", "use_rules",
    "constrain", "active_rules",
]

# A candidate is one mesh axis or a tuple of mesh axes (combined sharding).
Candidate = Union[str, Tuple[str, ...]]
Rules = Dict[str, Tuple[Candidate, ...]]
Spec = Tuple[Optional[Candidate], ...]


def _base_rules() -> Rules:
    return {
        # activations
        "batch": (("pod", "data"), "data"),
        "seq": ("model",),
        "cache_seq": ("model",),
        # embeddings / head
        "vocab": ("model",),
        # attention
        "heads": ("model",),
        "kv_heads": ("model",),
        # fallback TP axis: when kv_heads don't divide the model axis (GQA
        # kv < 16) the K/V projections shard their head_dim instead of
        # replicating
        "head_dim": ("model",),
        # mlp
        "d_ff": ("model",),
        # moe
        "experts": ("model",),
        "expert_ff": (("model", "data"), "model", "data"),
        "experts_router": (),
        "capacity": ("data",),
        # ssm
        "ssm_heads": ("model",),
        "ssm_channels": ("model",),
        # fallback: SSD math is linear in the head dim, so when ssm_heads
        # don't divide the model axis (hymba: 25) the head dim shards instead
        "ssm_head_dim": ("model",),
        "ssm_state": (),
        "ssm_groups": (),
        "conv_k": (),
        # structure
        "layers": (),
        "d_model": (),
    }


def train_rules(multi_pod: bool = False) -> Rules:
    r = _base_rules()
    # ZeRO-3/FSDP: weight rows sharded over the data(+pod) axes
    r["d_model"] = (("pod", "data"), "data") if multi_pod else ("data",)
    r["expert_ff"] = ("model",)
    return r


def serve_rules(multi_pod: bool = False) -> Rules:
    r = _base_rules()
    # decode: weights stay TP-resident (no per-step regather); big MLP/expert
    # ff dims take 2D (model×data) tensor parallelism
    r["d_model"] = ()
    r["d_ff"] = (("model", "data"), "model")
    return r


TRAIN_RULES = train_rules()
SERVE_RULES = serve_rules()


def _sizes(mesh: Union[Mesh, Dict[str, int]]) -> Dict[str, int]:
    return mesh.sizes if isinstance(mesh, Mesh) else dict(mesh)


def spec_for(p: P, rules: Rules, mesh: Union[Mesh, Dict[str, int]]) -> Spec:
    """Each dimension's mesh axes: None, an axis name, or a tuple of names."""
    sizes = _sizes(mesh)
    used: set = set()
    out = []
    for dim, logical in zip(p.shape, p.logical):
        chosen: Optional[Candidate] = None
        for cand in rules.get(logical or "", ()):
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a not in sizes for a in axes) or any(a in used for a in axes):
                continue
            total = math.prod(sizes[a] for a in axes)
            if total > 1 and dim % total == 0:
                chosen = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                break
        out.append(chosen)
    return tuple(out)


def _axes_of(entry: Optional[Candidate]) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(p: P, rules: Rules, mesh: Union[Mesh, Dict[str, int]]) -> Tuple[int, ...]:
    """The shape of one device's shard of ``p``."""
    sizes = _sizes(mesh)
    return tuple(dim // math.prod(sizes[a] for a in _axes_of(entry))
                 for dim, entry in zip(p.shape, spec_for(p, rules, mesh)))


def local_bytes(p: P, rules: Rules, mesh: Union[Mesh, Dict[str, int]], default_dtype) -> int:
    """Bytes of one device's shard of ``p`` in its dtype (its pin, else
    ``default_dtype``)."""
    itemsize = torch.empty((), dtype=p.with_dtype(default_dtype)).element_size()
    return math.prod(local_shape(p, rules, mesh)) * itemsize


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return [_map(fn, v) for v in tree]


def tree_shardings(spec_tree: Any, rules: Rules, mesh: Union[Mesh, Dict[str, int]]) -> Any:
    """:func:`spec_for` over every P leaf of a spec tree."""
    return _map(lambda p: spec_for(p, rules, mesh), spec_tree)


def tree_local_bytes(spec_tree: Any, rules: Rules, mesh: Union[Mesh, Dict[str, int]],
                     default_dtype) -> int:
    """One device's bytes of every leaf of a spec tree."""
    total = 0

    def add(p: P) -> None:
        nonlocal total
        total += local_bytes(p, rules, mesh, default_dtype)

    _map(add, spec_tree)
    return total


# ------------------------------------------------------------------ context
class _Ctx(threading.local):
    mesh: Optional[Mesh] = None
    rules: Optional[Rules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(mesh: Optional[Mesh], rules: Optional[Rules]):
    """Activate (mesh, rules) for :func:`constrain` inside model code."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_rules() -> Tuple[Optional[Mesh], Optional[Rules]]:
    return _CTX.mesh, _CTX.rules


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """The reference's layout pin by logical axes.  The port runs every tensor
    whole on one card, so this returns ``x`` itself; with rules active it
    checks that ``logical`` names every dimension."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is not None and rules is not None and len(logical) != x.dim():
        raise ValueError(f"{len(logical)} logical axes {tuple(logical)} for a tensor of "
                         f"{x.dim()} dimensions")
    return x
