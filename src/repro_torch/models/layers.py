"""Shared layers: param specs, norms, MLPs, rotary embeddings.

Parameters are declared via :class:`P` leaf specs carrying *logical axis*
names, as in the reference package (``repro/models/layers.py``).  One spec
tree is the source of truth for initialization and for the layouts the
parity tests compare.  Everything here is a plain function on tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["P", "spec_leaves", "torch_dtype", "dtype_of", "init_leaf", "norm_params",
           "apply_norm", "mlp_params", "apply_mlp", "rope"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: Any) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


class P:
    """Parameter/state leaf spec: shape + logical axes + init scheme.

    ``dtype`` (optional) pins the leaf's dtype; None defers to the caller's
    default (the model dtype).
    """

    __slots__ = ("shape", "logical", "init", "scale", "dtype")

    def __init__(self, shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
                 init: str = "normal", scale: float = 1.0, dtype: Optional[str] = None):
        assert len(shape) == len(logical), (shape, logical)
        self.shape = tuple(int(s) for s in shape)
        self.logical = tuple(logical)
        self.init = init
        self.scale = scale
        self.dtype = dtype

    def with_dtype(self, default) -> torch.dtype:
        return torch_dtype(self.dtype or default)

    def __repr__(self) -> str:
        return f"P{self.shape}:{self.logical}:{self.init}"


def spec_leaves(tree: Any) -> List[P]:
    """The P leaves of a nested dict/list spec tree, in insertion order."""
    if isinstance(tree, P):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [p for sub in items for p in spec_leaves(sub)]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def init_leaf(generator: torch.Generator, p: P, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """Materialize one leaf, the reference's scheme drawn from ``generator``
    (which must live on ``device``)."""
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init in ("normal", "embed"):
        if p.init == "normal":  # fan-in scaled normal
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            std = p.scale / math.sqrt(max(fan_in, 1))
        else:
            std = 0.02
        x = torch.randn(p.shape, generator=generator, device=device, dtype=torch.float32)
        return (x * std).to(dtype)
    raise ValueError(p.init)


# ---------------------------------------------------------------------- norms
def norm_params(cfg: ModelConfig) -> Dict[str, P]:
    """Norm params; 'layernorm_np' (OLMo non-parametric LN) has none."""
    if cfg.norm == "layernorm_np":
        return {}
    out = {"scale": P((cfg.d_model,), ("d_model",), "ones")}
    if cfg.norm == "layernorm" and cfg.use_bias:
        out["bias"] = P((cfg.d_model,), ("d_model",), "zeros")
    return out


def apply_norm(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm / layernorm / layernorm_np over the last axis, computed in f32
    and cast back to x's dtype."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        y = y * params["scale"].float()
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm == "layernorm":
            y = y * params["scale"].float()
            if "bias" in params:
                y = y + params["bias"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------------- MLPs
def mlp_params(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, P]:
    f = d_ff or cfg.d_ff
    d = cfg.d_model
    wo_scale = 1.0 / math.sqrt(2 * cfg.n_layers or 2)
    if cfg.mlp == "swiglu":
        return {
            "wi_gate": P((d, f), ("d_model", "d_ff")),
            "wi_up": P((d, f), ("d_model", "d_ff")),
            "wo": P((f, d), ("d_ff", "d_model"), scale=wo_scale),
        }
    out = {
        "wi": P((d, f), ("d_model", "d_ff")),
        "wo": P((f, d), ("d_ff", "d_model"), scale=wo_scale),
    }
    if cfg.use_bias:
        out["bi"] = P((f,), ("d_ff",), "zeros")
        out["bo"] = P((d,), ("d_model",), "zeros")
    return out


def apply_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
        return h @ params["wo"]
    h = x @ params["wi"]
    if "bi" in params:
        h = h + params["bi"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)  # jax.nn.gelu defaults to tanh
    y = h @ params["wo"]
    if "bo" in params:
        y = y + params["bo"]
    return y


# -------------------------------------------------------------------- rotary
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply rotary embedding. x: (..., seq, heads, hd); positions: (..., seq)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(0, half, dtype=torch.float32,
                                                       device=x.device) / half)
    ang = positions[..., :, None].float() * freqs           # (..., seq, half)
    cos = torch.cos(ang)[..., :, None, :]                   # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)
