"""Hopper row RMSNorm: the wrapper of ``csrc/rmsnorm.cu``.

The port of ``repro/kernels/rmsnorm/kernel.py:rmsnorm_pallas``.  The CUDA
source says what bounds the kernel and how it is laid out; this module
checks what the kernel takes, allocates y and launches it on PyTorch's
current stream through a ``ctypes`` binding of the library that
:mod:`repro_torch.kernels.build` compiles at first use.

A CPU tensor goes to the plain version, :func:`ref.rmsnorm`; that is the
only route to it.  A CUDA tensor launches the kernel or raises.
``rmsnorm.launches`` counts launches.  Unlike the Pallas kernel, whose
``block_rows`` halves until it divides the rows, this one masks a ragged
last block.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import build
from . import ref

__all__ = ["rmsnorm", "BLOCK_ROWS", "ROW_THREADS"]

BLOCK_ROWS = (1, 2, 4, 8, 16)      # rows per CUDA block (a launch parameter)
ROW_THREADS = (32, 64, 128, 256)   # compiled threads per row
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SCALE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=1)
def _entry():
    fn = build.load("rmsnorm").repro_rmsnorm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return fn


def _check(x: torch.Tensor, scale: torch.Tensor, residual: Optional[torch.Tensor],
           block_rows: int, row_threads: int) -> None:
    tensors = {"x": x, "scale": scale}
    if residual is not None:
        tensors["residual"] = residual
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors.values()):
        raise ValueError("rmsnorm kernel needs every tensor on one CUDA device; got "
                         + ", ".join(f"{k} {t.device}" for k, t in tensors.items()))
    if x.dtype not in _DTYPE_CODE or (residual is not None and residual.dtype != x.dtype):
        raise ValueError(f"rmsnorm kernel takes float32 or bfloat16 x and residual of one "
                         f"dtype; got {x.dtype}"
                         + (f", {residual.dtype}" if residual is not None else ""))
    if scale.dtype not in _SCALE_CODE:
        raise ValueError(f"rmsnorm kernel takes a float32, bfloat16 or float16 scale; "
                         f"got {scale.dtype}")
    if x.dim() == 0 or x.shape[-1] == 0 or x.numel() == 0:
        raise ValueError(f"rmsnorm kernel needs a non-empty (..., d) x; got {tuple(x.shape)}")
    if tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"scale {tuple(scale.shape)} does not fit x {tuple(x.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} does not fit x {tuple(x.shape)}")
    if block_rows not in BLOCK_ROWS or row_threads not in ROW_THREADS:
        raise ValueError(f"block_rows={block_rows}, row_threads={row_threads}: the kernel "
                         f"takes {BLOCK_ROWS} and {ROW_THREADS}")
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{k} must be contiguous")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, residual: Optional[torch.Tensor] = None,
            eps: float = 1e-5, *, block_rows: int = 1, row_threads: int = 32) -> torch.Tensor:
    """x: (..., d); scale: (d,); residual: x's shape and dtype or None.
    Returns rmsnorm(x [+ residual]) * scale in x's dtype and shape."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, residual, eps)
    _check(x, scale, residual, block_rows, row_threads)
    d = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    y = torch.empty_like(x)
    err = _entry()(
        x.data_ptr(), residual.data_ptr() if residual is not None else None, scale.data_ptr(),
        y.data_ptr(), _DTYPE_CODE[x.dtype], _SCALE_CODE[scale.dtype], rows, d, float(eps),
        block_rows, row_threads, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
