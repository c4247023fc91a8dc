"""Hopper flash-attention forward: the wrapper of ``csrc/flash_attention.cu``.

The port of ``repro/kernels/flash_attention/kernel.py:flash_attention_pallas``.
The CUDA source says what bounds the kernel and how it is laid out; this
module checks what the kernel takes, allocates the output and launches it
on PyTorch's current stream through a ``ctypes`` binding of the library
that :mod:`repro_torch.kernels.build` compiles at first use.

A CPU tensor goes to the plain version, :func:`ref.naive_attention`; that
is the only route to it.  A CUDA tensor launches the kernel or raises.
``flash_attention.launches`` counts launches, so a run can show that its
prefill went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import build
from . import ref

__all__ = ["flash_attention", "TILES", "HEAD_DIMS"]

TILES = (32, 64)             # compiled block_q / block_kv values
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def _entry():
    fn = build.load("flash_attention").repro_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int, block_kv: int) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 q, k, v of one "
                         f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,Sq,H,D) and k, v (B,Sk,K,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree (H % K must be 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if sq == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if block_q not in TILES or block_kv not in TILES:
        raise ValueError(f"block_q={block_q}, block_kv={block_kv}: compiled tiles are {TILES}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, q_offset: int = 0,
    block_q: int = 64, block_kv: int = 64, scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D) with H % K == 0. Returns (B, Sq, H, D).

    Sequences need not divide the tiles: the kernel masks the ragged edge.
    """
    if q.device.type == "cpu":
        return ref.naive_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    _check(q, k, v, block_q, block_kv)
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
        b, sq, sk, h, n_kv, d, int(causal), int(window), int(q_offset),
        scale or 1.0 / math.sqrt(d), block_q, block_kv,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
