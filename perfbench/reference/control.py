"""The control: the reference computed in the next precision below bfloat16,
float8 (e4m3) products: both operands of every product with a weight are
rounded to float8 with one scale per output channel of the weight (the amax
over the dimensions the product contracts) and per row of the activation,
mapped to 448, and multiplied in float32.  Gradients pass straight through
the rounding, so the same control can be trained."""
from __future__ import annotations

from typing import Tuple

import torch

E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
    """``t`` rounded to float8 e4m3, one scale per slice over ``axes``, and
    back to float32."""
    with torch.no_grad():
        amax = t.abs().amax(dim=axes, keepdim=True).clamp(min=1e-30)
        scale = amax / E4M3_MAX
        q = (t / scale).clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach() if t.requires_grad else q


class Fp8:
    """float8 products (module docstring)."""

    def w(self, t: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
        return fp8_round(t, axes)

    def x(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t, (-1,))


FP8 = Fp8()
