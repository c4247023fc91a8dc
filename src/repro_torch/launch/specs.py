"""Cell builder: (arch × shape × mesh) → the plain step body and its arguments.

The port of ``repro/launch/specs.py``.  :func:`build_cell` returns what
:mod:`.dryrun` needs to trace a cell without allocating a byte: the step
body of :mod:`repro_torch.runtime.steps` (``make_train_step``,
``make_prefill_step``, ``make_decode_step``: the plain, uncaptured bodies,
not the server's graphs or the registry's steps) and its arguments as
``meta`` tensors (shapes and dtypes, no storage), built from the spec
trees.  On a sharded mesh (``single``, ``multi``) the arguments are meta
DTensors placed by the cell's rules on the ``DeviceMesh`` of
:func:`.mesh.traced_group`, and the step runs as rank 0's local program of
the sharded step (:mod:`repro_torch.parallel.sharding`).
:func:`cell_specs` gives the same arguments as spec trees.

:func:`model_flops`, :func:`flops_param_count`, :func:`depth_units` and
:func:`scaled_config` are the reference's, number for number.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import get_config
from ..models import model as M
from ..models.config import ModelConfig
from ..models.layers import P, dtype_of
from ..parallel import sharding as shd
from ..runtime import steps as rt_steps
from .mesh import Mesh, get_mesh
from .shapes import SHAPES, Shape, cell_status

__all__ = ["CellPlan", "build_cell", "plan_cell", "cell_specs", "meta_tree",
           "model_flops", "flops_param_count", "scaled_config", "depth_units", "cell_rules"]


def depth_units(cfg: ModelConfig) -> int:
    """Number of repeated depth units (vlm: cross-attn groups; encdec: paired
    enc+dec layers; otherwise layers).  Counters are linear in this unit."""
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_attn_period
    return cfg.n_layers


def scaled_config(cfg: ModelConfig, k: int) -> ModelConfig:
    """Same architecture at k depth units (for the dry-run counter passes)."""
    if cfg.family == "vlm":
        return dataclasses.replace(cfg, n_layers=k * cfg.cross_attn_period)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=k, enc_layers=k)
    return dataclasses.replace(cfg, n_layers=k)


def flops_param_count(cfg: ModelConfig) -> int:
    """Params that do matmul work per token (embedding gather excluded;
    the logits head counted once)."""
    total = cfg.param_count()
    if not cfg.tie_embeddings:
        total -= cfg.padded_vocab * cfg.d_model  # input embedding gather
    return total


def model_flops(cfg: ModelConfig, shape: Shape) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D serve (N = active matmul params,
    D = tokens processed per step); the attention O(S²) term is excluded by
    the textbook convention, and the ratio column of the roofline table
    surfaces it."""
    n = flops_param_count(cfg)
    if cfg.is_moe:
        n_total = cfg.param_count()
        n_active = cfg.active_param_count()
        n = n - (n_total - n_active)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    d = shape.global_batch  # decode: one token per sequence
    return 2.0 * n * d


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: Shape
    step: Callable
    args: Tuple[Any, ...]
    rules: shd.Rules
    meta: Dict[str, Any]
    mesh: Mesh
    device_mesh: Any = None


def cell_rules(shape: Shape, mesh: Mesh) -> shd.Rules:
    multi_pod = "pod" in mesh.sizes
    return shd.train_rules(multi_pod) if shape.kind == "train" else shd.serve_rules(multi_pod)


def _modal_spec(cfg: ModelConfig, batch: int, seq_len: int) -> Optional[P]:
    if cfg.family == "encdec":
        return P((batch, seq_len, cfg.d_model), ("batch", "seq", "d_model"))
    if cfg.family == "vlm":
        return P((batch, cfg.num_modal_tokens, cfg.d_model), ("batch", "seq", "d_model"))
    return None


def cell_specs(cfg: ModelConfig, shape: Shape) -> Dict[str, Any]:
    """The step's arguments as spec trees, by name: ``state`` and ``batch``
    (train), ``params`` and ``batch`` (prefill), ``params`` and ``dstate``
    (decode).  Token ids are int64, as the port's embedding and loss take
    them; a decode state's ``pos`` is per row, as the server keeps it."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": P((b, s), ("batch", "seq"), "zeros", dtype="int64")}
        if shape.kind == "train":
            batch["labels"] = P((b, s), ("batch", "seq"), "zeros", dtype="int64")
        modal = _modal_spec(cfg, b, s)
        if modal is not None:
            batch["modal"] = modal
        if shape.kind == "train":
            return {"state": rt_steps.train_state_specs(cfg), "batch": batch}
        return {"params": M.param_specs(cfg), "batch": batch}
    dstate = {"token": P((b,), ("batch",), "zeros", dtype="int64"),
              "caches": M.cache_specs(cfg, b, s, enc_len=s),
              "pos": P((b,), ("batch",), "zeros", dtype="int64")}
    return {"params": M.param_specs(cfg), "dstate": dstate}


def meta_tree(spec_tree: Any, default_dtype: torch.dtype) -> Any:
    """``meta`` tensors of a spec tree's shapes and dtypes: nothing allocated."""
    if isinstance(spec_tree, P):
        return torch.empty(spec_tree.shape, dtype=spec_tree.with_dtype(default_dtype),
                           device="meta")
    if isinstance(spec_tree, dict):
        return {k: meta_tree(v, default_dtype) for k, v in spec_tree.items()}
    return [meta_tree(v, default_dtype) for v in spec_tree]


def build_cell(arch: str, shape_name: str, mesh: Any = "one", *, microbatches: int = 1,
               depth_k: Optional[int] = None, cfg: Optional[ModelConfig] = None,
               shape: Optional[Shape] = None, device_mesh: Any = None) -> CellPlan:
    """The cell's plain step body and its ``meta`` arguments.  On a mesh of
    more than one device the arguments are meta DTensors on ``device_mesh``,
    the ``DeviceMesh`` of :func:`.mesh.traced_group` (the step must run
    inside it).  ``depth_k`` cuts the model to k depth units; ``cfg`` and
    ``shape`` stand in for the named config and shape (reduced cells)."""
    m = get_mesh(mesh) if isinstance(mesh, str) else mesh
    if m.size != 1 and device_mesh is None:
        raise ValueError(f"mesh {m.name!r} has {m.size} devices: build its cell inside "
                         "launch.mesh.traced_group and pass its device_mesh")
    cfg = cfg or get_config(arch)
    if depth_k is not None:
        cfg = scaled_config(cfg, depth_k).validate()
    shape = shape or SHAPES[shape_name]
    runs, reason = cell_status(cfg, shape)
    if not runs:
        raise ValueError(f"cell ({arch}, {shape_name}) skipped: {reason}")
    rules = cell_rules(shape, m)
    meta: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": m.name,
        "n_params": cfg.param_count(), "n_active_params": cfg.active_param_count(),
        "model_flops": model_flops(cfg, shape), "chips": m.size,
        "depth_units": depth_units(cfg), "microbatches": microbatches,
    }
    dt = dtype_of(cfg)
    args = {k: meta_tree(v, dt) for k, v in cell_specs(cfg, shape).items()}
    if device_mesh is not None:
        args = shd.distribute(args, cell_specs(cfg, shape), rules, device_mesh)
    return plan_cell(arch, shape, cfg, args, m, rules, meta, microbatches, device_mesh)


def plan_cell(arch: str, shape: Shape, cfg: ModelConfig, args: Dict[str, Any], m: Mesh,
              rules: shd.Rules, meta: Dict[str, Any], microbatches: int = 1,
              device_mesh: Any = None) -> CellPlan:
    """The cell's step body over ``args`` (:func:`cell_specs`' trees of
    tensors in the stacked layout, placed or not), its stacks unstacked."""
    if shape.kind == "train":
        state = args["state"]
        state["params"] = M.unstack_blocks(state["params"], cfg)
        state["opt"]["m"] = M.unstack_blocks(state["opt"]["m"], cfg)
        state["opt"]["v"] = M.unstack_blocks(state["opt"]["v"], cfg)
        raw_train = rt_steps.make_train_step(cfg, microbatches=microbatches)

        def train_step(state, batch, lr_scale=1.0):
            with shd.use_rules(m, rules, device_mesh):
                return raw_train(state, batch, lr_scale)

        return CellPlan(arch, shape, train_step, (state, args["batch"]), rules, meta, m,
                        device_mesh)

    params = M.unstack_blocks(args["params"], cfg)
    if shape.kind == "prefill":
        raw_prefill = rt_steps.make_prefill_step(cfg, cache_capacity=shape.seq_len)

        def prefill_step(params, batch):
            with shd.use_rules(m, rules, device_mesh), torch.no_grad():
                return raw_prefill(params, batch)

        return CellPlan(arch, shape, prefill_step, (params, args["batch"]), rules, meta, m,
                        device_mesh)

    raw_decode = rt_steps.make_decode_step(cfg)

    def decode_step(params, dstate):
        with shd.use_rules(m, rules, device_mesh), torch.no_grad():
            return raw_decode(params, dstate)

    return CellPlan(arch, shape, decode_step, (params, args["dstate"]), rules, meta, m,
                    device_mesh)
