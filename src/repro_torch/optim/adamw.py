"""AdamW over the port's parameter trees: float32 moments, float32 update math.

The port of ``repro/optim/adamw.py``.  State is ``{"m": tree, "v": tree,
"count": 0-d int32 tensor}``; ``m`` and ``v`` are float32 whatever the
parameters' dtype, and each update is computed in float32 and cast back to
the parameter's dtype, as the reference does.  ``torch.optim.AdamW`` is
not used: it keeps its moments in the parameter's dtype (bf16 here).

One departure, for memory: :func:`adamw_update` writes the new parameters,
``m`` and ``v`` IN PLACE (the reference returns new trees), so a full-width
step holds one copy of the state, not two.  It returns the same trees.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..tree import leaves, tree_map

__all__ = ["adamw_init", "adamw_update", "global_norm", "clip_by_global_norm"]


def adamw_init(params: Any) -> Dict[str, Any]:
    zeros = lambda t: tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), t)
    device = leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf by
    leaf in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), norm


@torch.no_grad()
def adamw_update(
    grads: Any,
    state: Dict[str, Any],
    params: Any,
    *,
    lr: Any,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step; returns (params, state, {"grad_norm"}), the trees
    updated in place.  ``grad_norm`` is the norm before clipping."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, clip_norm) if clip_norm is not None else None
    count = state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - b1 ** cf
    bc2 = 1.0 - b2 ** cf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=cf.device)
    for g, m, v, p in zip(leaves(grads), leaves(state["m"]), leaves(state["v"]), leaves(params)):
        if scale is not None:
            g = g * scale.to(g.dtype)      # the clip runs in the gradient's dtype
        g = g.float()
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        pf = p.float()
        p.copy_(pf - lr * (step + weight_decay * pf))
    return params, {"m": state["m"], "v": state["v"], "count": count}, {"grad_norm": gnorm}
