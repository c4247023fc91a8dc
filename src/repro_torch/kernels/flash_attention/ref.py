"""Plain PyTorch attention (GQA + causal + sliding window).

The port of ``repro/kernels/flash_attention/ref.py``, with its semantics
kept exactly: masked scores are −1e30 (never −inf), the online-softmax sum
``l`` is clamped at 1e-30, probabilities are cast to v's dtype before the
PV product, and the output is cast to q's dtype.

  * :func:`naive_attention` — materializes the full score matrix; the
    numerical oracle for everything else, and the plain version of the
    Hopper kernel (``kernel.py``).
  * :func:`scan_attention` — a loop over KV blocks with online softmax
    (masked blocks computed too).
  * :func:`unrolled_attention` — a loop over Q blocks, each attending only
    to its causal KV prefix (and window).
  * :func:`decode_attention` — one token against a (ring-buffered) cache.

All take q: (B, Sq, H, D), k/v: (B, Sk, K, D) with H % K == 0 and return
(B, Sq, H, D).  ``q_offset`` positions q tokens at ``q_offset + arange(Sq)``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

__all__ = ["naive_attention", "scan_attention", "unrolled_attention", "decode_attention"]

_NEG_INF = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window:
        m &= (qpos[:, None] - kpos[None, :]) < window
    return m


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(b,q,k,g,d) × (b,s,k,d) → f32 scores (b,k,g,q,s)."""
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale


def naive_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
    q_offset: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    scale = scale or 1.0 / math.sqrt(d)
    s = _scores(_group_q(q, n_kv), k, scale)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    s = torch.where(_mask(qpos, kpos, causal, window)[None, None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def _online_block(carry: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], kb: torch.Tensor,
                  vb: torch.Tensor, qg: torch.Tensor, kpos_b: torch.Tensor, qpos: torch.Tensor,
                  causal: bool, window: int, scale: float):
    """One online-softmax update. carry = (acc, m, l); shapes:
    acc (b,k,g,sq,d) f32; m,l (b,k,g,sq); kb/vb (b,blk,k,d)."""
    acc, m, l = carry
    s = _scores(qg, kb, scale)
    s = torch.where(_mask(qpos, kpos_b, causal, window)[None, None, None], s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p.to(vb.dtype).float(),
                                                vb.float())
    return acc, m_new, l


def scan_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
    q_offset: int = 0, scale: Optional[float] = None, block_kv: int = 512,
) -> torch.Tensor:
    """Loop over KV blocks with online softmax (masked blocks computed)."""
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    scale = scale or 1.0 / math.sqrt(d)
    block_kv = min(block_kv, sk)
    if sk % block_kv:
        raise ValueError(f"seq {sk} % block_kv {block_kv} != 0")
    g = h // n_kv
    qg = _group_q(q, n_kv)
    qpos = q_offset + torch.arange(sq, device=q.device)
    carry = (torch.zeros((b, n_kv, g, sq, d), dtype=torch.float32, device=q.device),
             torch.full((b, n_kv, g, sq), _NEG_INF, dtype=torch.float32, device=q.device),
             torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=q.device))
    for k0 in range(0, sk, block_kv):
        kpos_b = k0 + torch.arange(block_kv, device=q.device)
        carry = _online_block(carry, k[:, k0:k0 + block_kv], v[:, k0:k0 + block_kv], qg,
                              kpos_b, qpos, causal, window, scale)
    acc, _, l = carry
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def unrolled_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
    q_offset: int = 0, scale: Optional[float] = None, block_q: int = 1024, block_kv: int = 512,
    exact_prefix: bool = True,
) -> torch.Tensor:
    """Loop over Q blocks; each block attends only to its causal KV prefix
    (and window), so masked-out blocks are never computed.

    ``exact_prefix=False`` computes the FULL KV range per Q block (masked
    blocks included) — the scan_attention FLOP semantics in unrolled form."""
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    scale = scale or 1.0 / math.sqrt(d)
    block_q = min(block_q, sq)
    if sq % block_q:
        raise ValueError(f"seq {sq} % block_q {block_q} != 0")
    outs = []
    for q0 in range(0, sq, block_q):
        q_hi = q_offset + q0 + block_q  # one past the last q position in the block
        k_hi = min(sk, q_hi) if causal and exact_prefix else sk
        k_lo = max(0, q_offset + q0 - window + 1) if window and exact_prefix else 0
        # align to block_kv for tidy shapes
        k_lo = (k_lo // block_kv) * block_kv
        k_hi = min(sk, ((k_hi + block_kv - 1) // block_kv) * block_kv)
        outs.append(naive_attention(
            q[:, q0:q0 + block_q], k[:, k_lo:k_hi], v[:, k_lo:k_hi], causal=causal,
            window=window, q_offset=q_offset + q0 - k_lo, scale=scale))
    return torch.cat(outs, dim=1)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    pos: Union[int, torch.Tensor], *, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffered) KV cache.

    q: (B, 1, H, D); caches: (B, C, K, D) where C = cache capacity.
    ``pos`` — scalar (int or 0-d tensor) or per-row ``(B,)`` tensor: number
    of tokens already in context (0-based index of the current token).  For
    windowed caches (C == window) the cache is a ring buffer indexed
    ``t % C``; validity is derived from ``pos``.
    """
    b, c, n_kv, d = k_cache.shape
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    s = _scores(_group_q(q, n_kv), k_cache, scale)        # (b,k,g,1,c)
    slot = torch.arange(c, device=q.device)
    # (1,1) for scalar pos, (B,1) per-row: one mask expression serves both.
    pos_r = pos.reshape(-1, 1) if isinstance(pos, torch.Tensor) else torch.full(
        (1, 1), int(pos), device=q.device)
    valid = slot[None, :] <= pos_r  # exact while pos < c
    if window and window == c:
        # ring buffer: slot holds token t where t ≡ slot (mod c) and t <= pos
        valid = valid | (pos_r >= c)
    s = torch.where(valid[:, None, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return o.reshape(b, 1, q.shape[2], d).to(q.dtype)
