"""Attention block: projections + rope + (self|cross) attention + KV caches.

The port of ``repro/models/attention.py``.  Full-sequence attention goes
through :mod:`repro_torch.kernels.flash_attention.ops`, so the tunable
impl/tile knobs apply, and on the card it runs the Hopper kernel: causal
self-attention, the encoder's non-causal self-attention, and
cross-attention (queries from ``x``, keys and values from a source of
another length: no rope, no mask, no window).

Conventions (as in the reference):
  * activations x: (B, S, d_model); q/k/v: (B, S, H|K, hd)
  * projections keep the reference layouts: wq/wk/wv (d, H|K, hd), wo (H, hd, d)
  * KV cache per layer: dict(k=(B, C, K, hd), v=(B, C, K, hd)); capacity
    C = cfg.cache_len(context) — a ring buffer when C == window.
  * a cross-attention cache holds the projected source (encoder output or
    modal embeddings): filled by prefill, read by decode, never written.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from ..kernels.flash_attention import ops as attn_ops
from .config import ModelConfig
from .layers import P, rope

__all__ = ["attn_params", "cross_attn_params", "attn_cache_spec", "apply_attn",
           "apply_attn_decode"]


def attn_params(cfg: ModelConfig, cross: bool = False) -> Dict[str, P]:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wo_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    out = {
        "wq": P((d, h, hd), ("d_model", "heads", "head_dim")),
        "wk": P((d, k, hd), ("d_model", "kv_heads", "head_dim")),
        "wv": P((d, k, hd), ("d_model", "kv_heads", "head_dim")),
        "wo": P((h, hd, d), ("heads", "head_dim", "d_model"), scale=wo_scale),
    }
    if cfg.use_bias:
        out["bq"] = P((h, hd), ("heads", "head_dim"), "zeros")
        out["bk"] = P((k, hd), ("kv_heads", "head_dim"), "zeros")
        out["bv"] = P((k, hd), ("kv_heads", "head_dim"), "zeros")
        out["bo"] = P((d,), ("d_model",), "zeros")
    if cfg.qk_norm and not cross:
        out["q_norm"] = P((hd,), ("head_dim",), "ones")
        out["k_norm"] = P((hd,), ("head_dim",), "ones")
    return out


def cross_attn_params(cfg: ModelConfig) -> Dict[str, P]:
    """Cross-attention projections: as self-attention's, never QK-normed."""
    return attn_params(cfg, cross=True)


def attn_cache_spec(cfg: ModelConfig, batch: int, context: int) -> Dict[str, P]:
    """Per-layer KV-cache leaf specs."""
    shape = (batch, cfg.cache_len(context), cfg.n_kv_heads, cfg.hd)
    logical = ("batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": P(shape, logical, "zeros"), "v": P(shape, logical, "zeros")}


def _qk_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) @ (d,N,hd) → contiguous (B,S,N,hd)."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).view(*x.shape[:-1], n, hd)


def _project_qkv(params: Dict[str, torch.Tensor], x: torch.Tensor, src: torch.Tensor,
                 cfg: ModelConfig, positions: Optional[torch.Tensor]):
    """q from ``x``, k and v from ``src``; rope at ``positions`` on both
    (self-attention) or none (``positions`` None: cross-attention)."""
    q, k, v = _proj(x, params["wq"]), _proj(src, params["wk"]), _proj(src, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if "q_norm" in params:
        q = _qk_rmsnorm(q, params["q_norm"])
        k = _qk_rmsnorm(k, params["k_norm"])
    if positions is None:
        return q, k, v
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _out(params: Dict[str, torch.Tensor], y: torch.Tensor) -> torch.Tensor:
    h, hd, d = params["wo"].shape
    y = y.reshape(*y.shape[:-2], h * hd) @ params["wo"].reshape(h * hd, d)
    return y + params["bo"] if "bo" in params else y


def apply_attn(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
               xkv: Optional[torch.Tensor] = None, causal: bool = True, q_offset: int = 0):
    """Full-sequence attention (prefill / forward).  Returns (y, (k, v)) so
    prefill can fill the cache.  Self-attention (``xkv`` None) ropes
    positions ``q_offset + 0..S-1`` — every position, a prompt's left pad
    included — under ``causal`` and the config's window.  Cross-attention
    (``xkv`` (B, S_src, d), the encoder output or modal embeddings) projects
    k and v from the source and attends without rope, mask or window."""
    if xkv is not None:
        q, k, v = _project_qkv(params, x, xkv, cfg, None)
        y = attn_ops.flash_attention(q, k, v, causal=False, window=0, q_offset=q_offset)
        return _out(params, y), (k, v)
    s = x.shape[1]
    pos = q_offset + torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, x, x, cfg, pos)
    y = attn_ops.flash_attention(q, k, v, causal=causal, window=cfg.window,
                                 q_offset=q_offset)
    return _out(params, y), (k, v)


def apply_attn_decode(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,                           # (B, 1, d_model)
    cache: Dict[str, torch.Tensor],
    pos: Union[int, torch.Tensor],             # scalar, or (B,) per-row positions
    cfg: ModelConfig,
    *,
    cross: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token attention against, and update of, a KV cache.

    The new token's K/V go to slot ``pos % C`` of each row (a ring buffer
    when C == window).  ``pos`` is a Python int (gang decode: every row at
    one position) or a ``(B,)`` tensor (continuous batching: each slot at
    its own position, rope phase and validity horizon).  The write updates
    ``cache`` IN PLACE — the reference returns a new cache, but each caller
    rebinds it anyway, and an in-place row write saves copying the whole
    cache every token.

    ``cross``: the cache is a static cross-attention cache (the projected
    source); q (no rope) attends to every one of its C positions, as the
    reference's ``pos = C - 1``, and nothing is written.
    """
    c = cache["k"].shape[1]
    if cross:
        q = _proj(x, params["wq"])
        if "bq" in params:
            q = q + params["bq"]
        y = attn_ops.decode_attention(q, cache["k"], cache["v"], c - 1)
        return _out(params, y), cache
    b = x.shape[0]
    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    positions = (pos[:, None] if per_row
                 else torch.full((1, 1), int(pos), device=x.device, dtype=torch.long))
    q, k, v = _project_qkv(params, x, x, cfg, positions)
    if per_row:
        rows = torch.arange(b, device=x.device)
        slot = pos % c
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    else:
        slot = int(pos) % c
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    y = attn_ops.decode_attention(q, cache["k"], cache["v"], pos, window=cfg.window)
    return _out(params, y), cache
