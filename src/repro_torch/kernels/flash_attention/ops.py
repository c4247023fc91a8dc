"""Public attention op: MLOS-tunable implementation + block-shape dispatch.

``attention_settings`` is the registered smart component
``torch_flash_attention``: its tunables (impl / block_q / block_kv) are
resolved per call for the call's workload signature, as in the reference
(``repro/kernels/flash_attention/ops.py``).  ``impl="kernel"`` (the
default) is the Hopper kernel of ``kernel.py``; its tiles are the ones it
was compiled for, which fit an SM's shared memory (the TPU's 128–2048 VMEM
tiles do not).  The plain implementations take the same tiles, aligned
to the sequence by halving.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.configstore import bucket_pow2
from ...core.registry import MetricSpec, tunable_component
from ...core.tunable import Categorical
from . import kernel, ref

__all__ = ["flash_attention", "decode_attention", "attention_settings",
           "AttentionKernelSettings", "workload_signature"]


@tunable_component(
    name="torch_flash_attention",
    tunables=(
        Categorical("impl", default="kernel",
                    choices=("naive", "scan", "unrolled", "unrolled_full", "kernel"),
                    description="attention algorithm / kernel path"),
        Categorical("block_q", default=64, choices=kernel.TILES,
                    description="Q tile (one CUDA block's rows)"),
        Categorical("block_kv", default=64, choices=kernel.TILES,
                    description="KV tile staged through shared memory"),
    ),
    metrics=(
        MetricSpec("time_us", "d"),
    ),
)
class AttentionKernelSettings:
    """Holder for the tunable attention kernel configuration."""


attention_settings = AttentionKernelSettings()


def workload_signature(b: int, s_q: int, s_kv: int, d: int) -> str:
    """Bucketed call-shape signature: batch and sequence bucket at powers of
    two; head_dim is structural and kept exact."""
    return f"b{bucket_pow2(b)}q{bucket_pow2(s_q)}k{bucket_pow2(s_kv)}d{d}"


def _align(block: int, seq: int) -> int:
    block = min(block, seq)
    while seq % block:
        block //= 2
    return max(block, 1)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, q_offset: int = 0,
    impl: Optional[str] = None, block_q: Optional[int] = None, block_kv: Optional[int] = None,
    workload: Optional[str] = None,
) -> torch.Tensor:
    """Attention entry point used by the model; dispatches on tunables
    resolved for this call's workload context (shape-derived unless pinned
    via ``workload=``)."""
    wl = workload or workload_signature(q.shape[0], q.shape[1], k.shape[1], q.shape[3])
    s = attention_settings.settings_for(wl)
    impl = impl or s["impl"]
    block_q = block_q or s["block_q"]
    block_kv = block_kv or s["block_kv"]
    if impl == "kernel":
        # the kernel masks ragged edges itself: its tiles need not divide
        return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, block_q=block_q, block_kv=block_kv)
    block_q, block_kv = _align(block_q, q.shape[1]), _align(block_kv, k.shape[1])
    if impl == "naive":
        return ref.naive_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if impl == "scan":
        return ref.scan_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                  block_kv=block_kv)
    if impl in ("unrolled", "unrolled_full"):
        return ref.unrolled_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            block_q=block_q, block_kv=block_kv, exact_prefix=impl == "unrolled")
    raise ValueError(f"unknown attention impl {impl!r}")


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0):
    return ref.decode_attention(q, k_cache, v_cache, pos, window=window)
