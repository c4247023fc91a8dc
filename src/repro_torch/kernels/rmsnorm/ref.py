"""Plain PyTorch RMSNorm (+ optional residual add): the plain version of
``csrc/rmsnorm.cu`` and the port of ``repro/kernels/rmsnorm/ref.py``."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["rmsnorm"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, residual: Optional[torch.Tensor] = None,
            eps: float = 1e-5) -> torch.Tensor:
    """y = rmsnorm(x + residual) * scale, computed in f32, cast to x's dtype."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)
