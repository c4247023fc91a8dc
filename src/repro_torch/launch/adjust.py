"""Kernel roofline adjustment.

The port of ``repro/launch/adjust.py``.  A ``meta`` trace cannot launch the
Hopper kernel (it is a ctypes call on device memory), so the dry-run's
counter traces run the kernel's plain FLOP-equivalent, ``unrolled_attention``
(only the unmasked KV blocks of each Q block), which writes its
(Sq × Skv-block) scores to device memory.  The kernel keeps them in shared
memory and registers: its memory traffic is Q, K, V read once and O written
once.  When the settings select the kernel, the dry-run replaces the
traced bytes of every forward attention call by that ideal traffic:

    delta per call = bytes(plain forward, traced alone at the cell's geometry)
                   − bytes_ideal,      bytes_ideal = |Q| + |K| + |V| + |O|

times the forward calls of a step: the self-attention layers (cross-attention
left out, conservatively, as in the reference), times 2 in a train step
under ``remat`` "full" or "dots" (the recompute runs the kernel again),
times the microbatches.  Decode attention is the plain ``decode_attention``
on every path, not the kernel: nothing to adjust.

On a sharded mesh the geometry is rank 0's: its batch rows, and its query
heads (head-parallel; its KV heads are its own, or where they do not divide
``model`` the ones its query heads read) or its query rows against every
key (sequence-parallel), as the kernel is launched inside the sharded
program (the reference's per-device Q/K/V/O sizes).

The backward is NOT adjusted: ``FlashAttentionFn`` recomputes
``naive_attention`` with autograd, so the trace already counts what the
port runs.  The reference's fused flash backward of 15/4 traversals
(``repro/launch/adjust.py:14-17``) is not carried over: no kernel performs
it.  FLOPs are not adjusted (the kernel does the same products); the SSD
scan stays counted as its plain chunked work, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..core.telemetry import op_counters
from ..kernels.flash_attention import ops as attn_ops
from ..kernels.flash_attention import ref as attn_ref
from ..models.config import ModelConfig
from ..models.layers import P, dtype_of
from ..models.transformer import stack_settings, stack_workload
from .mesh import Mesh
from .shapes import Shape

__all__ = ["attention_adjustment", "attn_layers_per_unit", "forward_calls_per_layer",
           "plain_forward", "local_geometry"]


def plain_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                  window: int = 0, q_offset: int = 0, block_q: int = 64, block_kv: int = 64,
                  scale=None) -> torch.Tensor:
    """The kernel's plain FLOP-equivalent at the kernel's tiles (aligned to
    the sequences by halving): what a counter trace runs where the card
    launches the kernel."""
    with torch.no_grad():
        return attn_ref.unrolled_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset, scale=scale,
            block_q=attn_ops._align(block_q, q.shape[1]),
            block_kv=attn_ops._align(block_kv, k.shape[1]))


def attn_layers_per_unit(cfg: ModelConfig) -> int:
    """Self-attention calls per depth unit (cross-attn excluded: conservative)."""
    return {"dense": 1, "moe": 1, "hybrid": 1, "ssm": 0,
            "encdec": 2,                       # enc self + dec self per paired unit
            "vlm": 1}[cfg.family] * (cfg.cross_attn_period if cfg.family == "vlm" else 1)


def forward_calls_per_layer(cfg: ModelConfig, shape: Shape, microbatches: int = 1) -> int:
    """Kernel forward calls per self-attention layer in one step: 1 a
    prefill; in a train step 1 per microbatch, 2 under a ``remat`` that
    recomputes the layer."""
    if shape.kind != "train":
        return 1
    b = shape.global_batch // microbatches
    remat = stack_settings.settings_for(
        stack_workload(cfg.family, b, shape.seq_len, cfg.n_layers))["remat"]
    return microbatches * (1 if remat == "none" else 2)


def local_geometry(cfg: ModelConfig, shape: Shape, microbatches: int = 1,
                   mesh: Optional[Mesh] = None) -> Tuple[int, int, int, int, int]:
    """(batch, query rows, keys, query heads, KV heads) of one kernel call of
    rank 0 on ``mesh`` (of the one device without one)."""
    b, s = shape.global_batch // microbatches, shape.seq_len
    h, k = cfg.n_heads, cfg.n_kv_heads
    if mesh is None or mesh.size == 1:
        return b, s, s, h, k
    from ..parallel import sharding as shd
    from .specs import cell_rules   # late import: specs imports the models' steps

    rules = cell_rules(shape, mesh)
    split = lambda e: math.prod(mesh.sizes[a] for a in shd._axes_of(e))
    b //= split(shd.spec_for(P((b, s), ("batch", "seq")), rules, mesh)[0])
    m = mesh.sizes.get("model", 1)
    if h % m:                                         # sequence-parallel: own rows
        return b, s // m, s, h, k
    hl = h // m
    return b, s, s, hl, k // m if k % m == 0 else max(1, hl // (h // k))


def attention_adjustment(cfg: ModelConfig, shape: Shape, microbatches: int = 1,
                         mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """Bytes to take off the traced total for the whole step (≥ 0) on one
    device (rank 0 of ``mesh``), and the terms it is made of."""
    from .specs import depth_units  # late import: specs imports the models' steps

    if cfg.attn_free or attn_layers_per_unit(cfg) == 0 or shape.kind == "decode":
        return {"delta_bytes": 0.0, "bytes_plain": 0.0, "bytes_ideal": 0.0, "attn_calls": 0}
    dt = dtype_of(cfg)
    b, sq, s, h, kh = local_geometry(cfg, shape, microbatches, mesh)
    q = torch.empty((b, sq, h, cfg.hd), dtype=dt, device="meta")
    k = torch.empty((b, s, kh, cfg.hd), dtype=dt, device="meta")
    tiles = attn_ops.attention_settings.settings_for(
        attn_ops.workload_signature(b, sq, s, cfg.hd))
    bytes_plain = op_counters(plain_forward, q, k, k, True, cfg.window, 0, tiles["block_q"],
                              tiles["block_kv"])["bytes_accessed"]
    per_tensor = q.numel() * q.element_size()
    bytes_ideal = 2 * per_tensor + 2 * k.numel() * k.element_size()     # Q + O + K + V
    calls = attn_layers_per_unit(cfg) * depth_units(cfg) * forward_calls_per_layer(
        cfg, shape, microbatches)
    delta = max(0.0, bytes_plain - bytes_ideal) * calls
    return {"delta_bytes": float(delta), "bytes_plain": float(bytes_plain),
            "bytes_ideal": float(bytes_ideal), "attn_calls": int(calls)}
