"""LR schedules as functions of the step counter (an int or a tensor).

The port of ``repro/optim/schedules.py``.  Each returns a float32 0-d
tensor on the step's device (the CPU for an int), computed in float32 as
the reference computes it, so a step counter held on the card gives an lr
on the card with no host sync.
"""
from __future__ import annotations

import math
from typing import Union

import torch

__all__ = ["warmup_cosine", "constant"]

Step = Union[int, torch.Tensor]


def _f32(step: Step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(step: Step, base_lr: float = 3e-4) -> torch.Tensor:
    return torch.full((), base_lr, dtype=torch.float32, device=_f32(step).device)


def warmup_cosine(step: Step, base_lr: float = 3e-4, warmup: int = 100, total: int = 10000,
                  min_frac: float = 0.1) -> torch.Tensor:
    s = _f32(step)
    warm = base_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
