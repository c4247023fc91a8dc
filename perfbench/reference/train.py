"""The reference's first train steps, followed leaf by leaf.

:func:`follow` trains a float32 copy of the benchmark's initial weights
through the same batches as the program's first steps: the loss of each
step, the per-leaf norms of the first step's gradient as AdamW gets it
(after the global-norm clip), and the per-leaf norms of the parameters'
change after the last step.  Rows are computed one at a time and their
gradients summed, so the whole batch never has to fit at once; each row's
loss is divided by the batch's count of labels, so the sum is the batch's
mean loss.  ``prec`` rounds both operands of every product with a weight (a
control in lower precision; the rounding passes gradients straight through).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .model import EXACT, Hyper, RefConfig, adamw_step, nll_sum


def _named(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _named(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def layer_leaves(w: Dict[str, Any], n_layers: int) -> Dict[str, torch.Tensor]:
    """Every leaf, a stacked block leaf split into its layers
    (``blocks.<l>.<path>``)."""
    out = {}
    for name, t in _named(w):
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for l in range(n_layers):
                out[f"blocks.{l}.{rest}"] = t[l]
        else:
            out[name] = t
    return out


def layer_norms(w: Dict[str, Any], n_layers: int) -> Dict[str, float]:
    """Norms of every leaf of :func:`layer_leaves`, in float32."""
    return {k: float(torch.linalg.vector_norm(t.float()))
            for k, t in layer_leaves(w, n_layers).items()}


def _map(tree: Any, fn) -> Any:
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def follow(w0: Dict[str, Any], m: RefConfig, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
           hp: Hyper, prec=EXACT, rows: Optional[Sequence[int]] = None
           ) -> Dict[str, Any]:
    """Train a float32 copy of ``w0`` through ``batches`` ((tokens, labels),
    each (B, S)); ``rows`` picks the rows each step sees (all by default).
    Returns {"loss": [per step], "grad": per-leaf norms of the first clipped
    gradient, "grads": that gradient's leaves (float32, on the host), "change":
    per-leaf norms of the last step's parameters minus ``w0``}."""
    params = _map(w0, lambda t: t.detach().float().clone().requires_grad_(True))
    named = _named(params)
    leaves = [t for _, t in named]
    mom = [torch.zeros_like(t) for t in leaves]
    vel = [torch.zeros_like(t) for t in leaves]
    losses, grad_norms, first = [], None, None
    for step, (tokens, labels) in enumerate(batches):
        pick = list(range(tokens.shape[0])) if rows is None else list(rows)
        count = sum(int((labels[r] >= 0).sum()) for r in pick)
        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for r in pick:
            nll = nll_sum(params, m, tokens[r], labels[r], prec) / count
            nll.backward()
            total += nll.detach()
        losses.append(float(total))
        grads = [t.grad for t in leaves]
        with torch.no_grad():
            if step == 0:
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(hp.clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
                clipped = _map(params, lambda t: (t.grad * scale).cpu())
                grad_norms = layer_norms(clipped, m.n_layers)
                first = layer_leaves(clipped, m.n_layers)
            adamw_step(leaves, grads, mom, vel, step, hp)
        for t in leaves:
            t.grad = None
    with torch.no_grad():
        change = layer_norms(_map2(params, w0, lambda p, p0: p - p0.float()), m.n_layers)
    return {"loss": losses, "grad": grad_norms, "grads": first, "change": change}


def _map2(a: Any, b: Any, fn) -> Any:
    if isinstance(a, dict):
        return {k: _map2(a[k], b[k], fn) for k in a}
    return fn(a, b)
