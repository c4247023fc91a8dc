"""Hopper flash-attention forward: the wrapper of the two CUDA sources.

The port of ``repro/kernels/flash_attention/kernel.py:flash_attention_pallas``.
The dispatch is by dtype, here and nowhere else:

  * bfloat16 → ``csrc/flash_attention_tc.cu``: both products on the tensor
    cores (wgmma), K/V tiles through TMA into a shared-memory ring;
  * float32 → ``csrc/flash_attention.cu``: exact f32 FMAs, because the
    float32 checks (170·eps, the reduced models on the card against the
    CPU) need full f32 products that TF32 tensor cores would break.

Neither is a fallback for the other: each library takes only its dtype.
The CUDA sources say what bounds each kernel and how it is laid out; this
module checks what the kernel takes, allocates the output and launches it
on PyTorch's current stream through a ``ctypes`` binding of the library
that :mod:`repro_torch.kernels.build` compiles at first use.

:func:`smem_bytes` and :func:`compiled` give each (dtype, block_q, block_kv,
head_dim) instance's dynamic shared memory and whether it is compiled; the
sources compile exactly the instances that fit a block's 227 KB, and the
wrapper refuses the others before it touches a library.

A CPU tensor goes to the plain version, :func:`ref.naive_attention`; that
is the only route to it.  A CUDA tensor launches a kernel or raises.
``flash_attention.launches`` counts launches of both kernels, so a run can
show that its prefill (or train step) went through them.

Gradients.  The TPU kernel has no backward kernel (the reference
differentiates its jnp path), so neither does this one.  A CUDA input that
requires grad goes through :class:`FlashAttentionFn`: the forward is the
kernel, and the backward recomputes :func:`ref.naive_attention` on the
saved q, k, v with autograd and backpropagates through it — the gradient
``jax.grad`` gives over the reference's plain path.  The output is never
detached from its inputs.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import build
from . import ref

__all__ = ["flash_attention", "FlashAttentionFn", "TILES", "HEAD_DIMS", "SOURCES", "smem_bytes",
           "compiled", "library_smem_bytes"]

TILES = (64, 128)            # block_q / block_kv values the sources are compiled for
HEAD_DIMS = (16, 32, 64, 128)
SMEM_LIMIT = 232448          # dynamic shared memory one block may use on Hopper (227 KB)
STAGES = 2                   # the tensor-core kernel's K/V ring
SOURCES = {torch.float32: "flash_attention", torch.bfloat16: "flash_attention_tc"}


def smem_bytes(dtype: torch.dtype, block_q: int, block_kv: int, d: int) -> int:
    """Dynamic shared memory of one instance, as its source computes it."""
    if dtype == torch.bfloat16:
        # 1024 bytes of alignment slack, Q, STAGES K and V tiles, the mbarriers
        return 1024 + 2 * (block_q * d + 2 * STAGES * block_kv * d) + 128
    if dtype == torch.float32:
        # q and k rows padded by one word, v, and the f32 probabilities
        ld = d + 1
        return 4 * (block_q * ld + block_kv * ld + block_kv * d) + 4 * block_q * (block_kv + 1)
    raise ValueError(f"no flash_attention kernel for {dtype}")


def compiled(dtype: torch.dtype, block_q: int, block_kv: int, d: int) -> bool:
    """Whether the instance exists: tiles in TILES, a head dim in HEAD_DIMS,
    and shared memory that fits a block."""
    return (dtype in SOURCES and block_q in TILES and block_kv in TILES and d in HEAD_DIMS
            and smem_bytes(dtype, block_q, block_kv, d) <= SMEM_LIMIT)


def library_smem_bytes(dtype: torch.dtype, block_q: int, block_kv: int, d: int) -> int:
    """The instance's dynamic shared memory as its built library computes it
    (-1 where the library compiles none); the card holds :func:`smem_bytes`
    and :func:`compiled` against it."""
    source = SOURCES[dtype]
    fn = getattr(build.load(source), f"repro_{source}_smem_bytes")
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3
    return fn(block_q, block_kv, d)


@functools.lru_cache(maxsize=None)
def _entry(source: str):
    lib = build.load(source)
    fn = getattr(lib, f"repro_{source}_fwd")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int, block_kv: int) -> None:
    if q.dtype not in SOURCES or k.dtype != q.dtype or v.dtype != q.dtype:
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
    if not compiled(q.dtype, block_q, block_kv, d):
        raise ValueError(f"(block_q={block_q}, block_kv={block_kv}) at head_dim {d} is not "
                         f"compiled for {q.dtype}: tiles are {TILES}, and a block has "
                         f"{SMEM_LIMIT} bytes of shared memory")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
            q_offset: int, block_q: int, block_kv: int, scale: Optional[float]) -> torch.Tensor:
    """Allocate the output and launch the dtype's kernel (checked inputs)."""
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    out = torch.empty_like(q)
    err = _entry(SOURCES[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, n_kv, d, int(causal), int(window), int(q_offset),
        scale or 1.0 / math.sqrt(d), block_q, block_kv,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient (see the
    module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block_q, block_kv, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
        return _launch(q, k, v, causal, window, q_offset, block_q, block_kv, scale)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = ref.naive_attention(*ins, **ctx.opts)
        dq, dk, dv = torch.autograd.grad(out, ins, dout)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, q_offset: int = 0,
    block_q: int = 64, block_kv: int = 64, scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D) with H % K == 0. Returns (B, Sq, H, D).

    Sequences need not divide the tiles: the kernels mask the ragged edge.
    Under autograd (an input requires grad) the launch goes through
    :class:`FlashAttentionFn`.
    """
    if q.device.type == "cpu":
        return ref.naive_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    _check(q, k, v, block_q, block_kv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset, block_q, block_kv,
                                      scale)
    return _launch(q, k, v, causal, window, q_offset, block_q, block_kv, scale)


flash_attention.launches = 0
