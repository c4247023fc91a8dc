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
:func:`local_bytes` give one device's shard.

Sharded programs are ``torch.distributed.tensor`` (DTensor) programs over
a ``DeviceMesh`` of the mesh's axes.  :func:`placements_for` turns a
resolved spec into DTensor placements: a mesh axis that shards dimension
``d`` is ``Shard(d)``, every other axis ``Replicate()``.  Where one
dimension is sharded over several axes (serve ``d_ff``'s ``("model",
"data")``), DTensor orders the shards by the mesh's dimensions, not by the
spec as JAX's ``PartitionSpec`` does: local shapes and bytes agree either
way, and every layout here is DTensor's own, so a tensor placed by
:func:`distribute` reassembles to itself.  The dry-run's meshes
(:func:`repro_torch.launch.mesh.traced_group`) list their dimensions in the
rules' order, so there the shards are JAX's too.  :func:`use_rules` with a ``device_mesh`` activates a sharded
mesh; then :func:`constrain` is ``x.redistribute(...)`` for a DTensor, and
:func:`local_call` runs a body on each rank's shards
(``torch.distributed.tensor.experimental.local_map``): the model's
mixers and the kernels inside them run there.  On the port's one card
(``one``: every axis of size 1), or with no rules, :func:`constrain` is
the identity: the port runs a tensor whole.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..launch.mesh import Mesh
from ..models.layers import P

__all__ = [
    "Rules", "TRAIN_RULES", "SERVE_RULES", "train_rules", "serve_rules", "spec_for",
    "local_shape", "local_bytes", "tree_shardings", "tree_local_bytes", "use_rules",
    "constrain", "active_rules", "sharded_mesh", "placements_for", "spec_placements",
    "distribute", "Layout", "layout_of", "local_call", "axis_rank", "mesh_sizes", "tp_axes",
    "entry", "is_dtensor", "row_block", "carry_rules",
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
    device_mesh: Any = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(mesh: Optional[Mesh], rules: Optional[Rules], device_mesh: Any = None):
    """Activate (mesh, rules) for :func:`constrain` inside model code; with a
    ``device_mesh`` of more than one device, a sharded program (the model
    then runs on DTensors, under ``implicit_replication``: a plain tensor
    made inside the step, a mask or a position, counts as replicated)."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.device_mesh)
    sharded = device_mesh is not None and device_mesh.size() > 1
    _CTX.mesh, _CTX.rules, _CTX.device_mesh = mesh, rules, device_mesh if sharded else None
    try:
        if sharded:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.device_mesh = prev


def active_rules() -> Tuple[Optional[Mesh], Optional[Rules]]:
    return _CTX.mesh, _CTX.rules


def carry_rules(fn: Callable) -> Callable:
    """``fn`` under the sharded mesh active now, wherever it is called: an
    activation checkpoint recomputes its function in the backward, which on
    the card runs in autograd's device thread (the context is per thread).
    Without a sharded mesh, ``fn`` itself."""
    ctx = (_CTX.mesh, _CTX.rules, _CTX.device_mesh)
    if ctx[2] is None:
        return fn

    @functools.wraps(fn)
    def run(*args: Any, **kwargs: Any) -> Any:
        with use_rules(*ctx):
            return fn(*args, **kwargs)

    return run


def sharded_mesh():
    """The active ``DeviceMesh`` when a sharded program runs, else None."""
    return _CTX.device_mesh


@functools.lru_cache(maxsize=1)
def _dt():
    """``torch.distributed.tensor``'s names, imported at first use."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    return DTensor, Shard, Replicate, Partial


def is_dtensor(x: Any) -> bool:
    return isinstance(x, _dt()[0])


def mesh_sizes(device_mesh) -> Dict[str, int]:
    return dict(zip(device_mesh.mesh_dim_names, device_mesh.mesh.shape))


def axis_rank(axis: str) -> int:
    """This rank's coordinate along ``axis`` of the active sharded mesh (0
    without one or without the axis)."""
    dm = _CTX.device_mesh
    if dm is None or axis not in dm.mesh_dim_names:
        return 0
    return dm.get_local_rank(axis)


class Layout(NamedTuple):
    """A tensor's layout over a mesh: per dimension None, an axis or a tuple
    of axes (a resolved spec), and the axes over which it holds partial
    values (``op`` "sum", "avg" or "max")."""

    dims: Tuple[Optional[Candidate], ...]
    partial: Tuple[str, ...] = ()
    op: str = "sum"


def spec_placements(spec: Union[Spec, Layout], device_mesh) -> Tuple[Any, ...]:
    """DTensor placements of a resolved spec (or a :class:`Layout`), one per
    mesh dimension: ``Shard(d)`` where the axis shards dimension ``d``,
    ``Partial`` where the layout is partial over it, else ``Replicate()``."""
    _, Shard, Replicate, Partial = _dt()
    layout = spec if isinstance(spec, Layout) else Layout(tuple(spec))
    out = []
    for name in device_mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(layout.dims) if name in _axes_of(e)]
        if name in layout.partial:
            out.append(Partial(layout.op))
        elif dims:
            out.append(Shard(dims[0]))
        else:
            out.append(Replicate())
    return tuple(out)


def placements_for(p: P, rules: Rules, device_mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``p`` under ``rules`` on ``device_mesh``."""
    return spec_placements(spec_for(p, rules, mesh_sizes(device_mesh)), device_mesh)


def layout_of(x: Any) -> Layout:
    """The :class:`Layout` of a DTensor's placements."""
    _, Shard, _, Partial = _dt()
    dims: list = [() for _ in range(x.dim())]
    partial, op = [], "sum"
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            dims[pl.dim] = (*dims[pl.dim], name)
        elif isinstance(pl, Partial):
            partial.append(name)
            op = pl.reduce_op
    return Layout(tuple(None if not d else d[0] if len(d) == 1 else d for d in dims),
                  tuple(partial), op)


def _place(t: torch.Tensor, p: P, rules: Rules, device_mesh) -> Any:
    DTensor = _dt()[0]
    placements = placements_for(p, rules, device_mesh)
    local = local_shape(p, rules, mesh_sizes(device_mesh))
    stride = torch.empty(p.shape, device="meta").stride()
    if tuple(t.shape) == tuple(p.shape) and t.device.type != "meta" and local != p.shape:
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, device_mesh, placements)
    if tuple(t.shape) == tuple(p.shape) and local != p.shape:
        t = torch.empty(local, dtype=t.dtype, device="meta")     # a meta tensor's shard
    elif tuple(t.shape) != tuple(local):
        raise ValueError(f"a tensor of shape {tuple(t.shape)} is neither the whole {p} nor "
                         f"its shard {local}")
    return DTensor.from_local(t, device_mesh, placements, run_check=False,
                              shape=torch.Size(p.shape), stride=stride)


def distribute(tree: Any, spec_tree: Any, rules: Rules, device_mesh) -> Any:
    """Place a tree of tensors on ``device_mesh`` by its spec tree: a whole
    tensor is split (``distribute_tensor``; every rank must hold the same
    one), a ``meta`` one becomes its shard's shape, and a tensor of the
    shard's shape is taken as this rank's shard (``DTensor.from_local``: a
    rank that cannot hold the whole, the card's rank 0)."""
    if isinstance(spec_tree, P):
        return _place(tree, spec_tree, rules, device_mesh)
    if isinstance(spec_tree, dict):
        return {k: distribute(tree[k], v, rules, device_mesh) for k, v in spec_tree.items()}
    return [distribute(t, v, rules, device_mesh) for t, v in zip(tree, spec_tree)]


def row_block(t: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Block ``i`` of ``n`` of the rows (dimension 0) of ``t``: of a DTensor,
    of each rank's own rows (a microbatch splits every rank's share of the
    batch; the split moves no data)."""
    if not is_dtensor(t):
        m = t.shape[0] // n
        return t[i * m:(i + 1) * m]
    local = t.to_local()
    m = local.shape[0] // n
    return _dt()[0].from_local(local[i * m:(i + 1) * m], t.device_mesh, t.placements,
                               run_check=False)


def tp_axes(batch_axes: Sequence[str], size: int) -> Tuple[str, ...]:
    """The axes that split a hidden dimension of ``size`` (an MLP's or an
    expert's ff) inside a local body: ``model`` plus every data axis that
    carries no batch rows (a B = 1 decode keeps its weights resident over
    them), the last dropped until their product divides ``size``."""
    sizes = mesh_sizes(_CTX.device_mesh)
    axes = tuple(a for a in ("model", "pod", "data") if a in sizes and a not in batch_axes)
    while axes and size % math.prod(sizes[a] for a in axes):
        axes = axes[:-1]
    return axes


def entry(axes: Sequence[str]) -> Optional[Candidate]:
    """A spec entry of ``axes``: None, one name, or the tuple."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """The reference's layout pin by logical axes.  In a sharded program a
    DTensor is redistributed to the layout ``logical`` resolves to;
    otherwise (one card, no rules) this returns ``x`` itself, having
    checked that ``logical`` names every dimension where rules are active."""
    mesh, rules, dm = _CTX.mesh, _CTX.rules, _CTX.device_mesh
    if mesh is not None and rules is not None and len(logical) != x.dim():
        raise ValueError(f"{len(logical)} logical axes {tuple(logical)} for a tensor of "
                         f"{x.dim()} dimensions")
    if dm is None or not is_dtensor(x):
        return x
    spec = spec_for(P(tuple(x.shape), tuple(logical), "zeros"), rules, mesh_sizes(dm))
    placements = spec_placements(spec, dm)
    return x if tuple(x.placements) == placements else x.redistribute(dm, placements)


def local_call(fn: Callable, out_layouts: Any, in_layouts: Any, *args: Any) -> Any:
    """``fn(*args)`` on each rank's shards of the active sharded mesh
    (``local_map``): every DTensor argument is first redistributed to its
    :class:`Layout` in ``in_layouts`` (a tree matching ``args``; None for a
    non-tensor), and each output becomes a DTensor of its layout in
    ``out_layouts`` (a tree matching the outputs).  Under autograd an input
    replicated over a mesh dimension that shards another input gets a
    partial gradient there: each rank's body saw its share of the work."""
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_flatten

    dm = _CTX.device_mesh
    leaf = lambda v: v is None or isinstance(v, Layout)
    flat_args = tree_flatten(args)[0]
    flat_in = tree_flatten(in_layouts, is_leaf=leaf)[0]
    if len(flat_in) != len(flat_args):
        raise ValueError(f"{len(flat_in)} input layouts for {len(flat_args)} arguments")
    _, Shard, Replicate, Partial = _dt()
    in_pl = [spec_placements(l, dm) if l is not None and is_dtensor(a) else None
             for l, a in zip(flat_in, flat_args)]
    # the mesh dimensions the body's work is split over: an input replicated
    # over one of them gets a partial gradient there (each rank's share)
    split = {i for pl in in_pl if pl is not None for i, q in enumerate(pl) if isinstance(q, Shard)}
    grad_pl = [None if pl is None else
               tuple(Partial() if i in split and isinstance(q, Replicate) else q
                     for i, q in enumerate(pl)) for pl in in_pl]
    out_pl = tuple(spec_placements(l, dm) if l is not None else None
                   for l in tree_flatten(out_layouts, is_leaf=leaf)[0])
    return local_map(fn, out_placements=out_pl, in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=dm, redistribute_inputs=True)(*args)
