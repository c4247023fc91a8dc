"""Shared layers: param specs, norms, MLPs, rotary embeddings.

Parameters are declared via :class:`P` leaf specs carrying *logical axis*
names, as in the reference package (``repro/models/layers.py``).  One spec
tree is the source of truth for initialization and for the layouts the
parity tests compare.  Everything here is a plain function on tensors.  In
a sharded program the MLP runs on each rank's shards: the sequence
gathered, ``d_ff`` split over ``model`` and every data axis that carries no
batch rows, a partial sum over them reduced into the residual's layout (a
decode gathers its few rows instead and keeps the weights where they are).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["P", "spec_leaves", "torch_dtype", "dtype_of", "init_leaf", "layer_axes", "norm_params",
           "apply_norm", "mlp_params", "apply_mlp", "rope"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int32": torch.int32, "int64": torch.int64}


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
        return _draw_normal(generator, p, std, dtype, device)
    # the SSM decay parameters stay float32 whatever the model dtype
    if p.init == "ssm_a":  # A_log: log of uniform [1, 16]
        u = torch.rand(p.shape, generator=generator, device=device, dtype=torch.float32)
        return torch.log(1.0 + 15.0 * u)
    if p.init == "ssm_dt":  # dt bias: softplus-inverse of dt log-uniform in [1e-3, 1e-1]
        u = torch.rand(p.shape, generator=generator, device=device, dtype=torch.float32)
        dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(p.init)


def layer_axes(p: P) -> int:
    """How many leading stacked (``"layers"``) axes the leaf ``p`` has."""
    k = 0
    while k < len(p.shape) - 1 and p.logical[k] == "layers":
        k += 1
    return k


def _draw_normal(generator: torch.Generator, p: P, std: float, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """``std`` times a standard normal draw of ``p``'s shape, in ``dtype``.

    A stacked leaf is drawn one layer at a time into the leaf, allocated
    once: each layer's float32 draw lands in one reused buffer, is scaled in
    place and cast into its layer (a leaf without a layer axis is one
    layer).  So a draw's peak is the leaf plus one float32 layer
    (command-r-35b's MLP leaf: 14.8 GB in bf16 and a 0.74 GB buffer, where a
    whole float32 draw and its cast would add 44 GB).  The rule depends on
    the spec alone, so a seed gives the same weights on every card whatever
    its free memory."""
    k = layer_axes(p)
    out = torch.empty(p.shape, dtype=dtype, device=device)
    buf = torch.empty(p.shape[k:], dtype=torch.float32, device=device)
    for layer in out.view(-1, *p.shape[k:]):
        layer.copy_(buf.normal_(generator=generator).mul_(std))
    return out


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
    y = y.to(x.dtype)
    if y.dim() == 3:      # the normed activations keep the residual's layout
        from ..parallel.sharding import constrain   # local: sharding imports this module

        y = constrain(y, ("batch", "seq", None))
    return y


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
    from ..parallel import sharding as shd

    if shd.sharded_mesh() is not None:
        return _mlp_sharded(params, x, cfg)
    y = _mlp_body(params, x, cfg)
    return y + params["bo"] if "bo" in params else y


def _mlp_body(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MLP up to ``bo``, on whole weights or on a rank's ``d_ff`` shards."""
    if cfg.mlp == "swiglu":
        h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
        return h @ params["wo"]
    h = x @ params["wi"]
    if "bi" in params:
        h = h + params["bi"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)  # jax.nn.gelu defaults to tanh
    return h @ params["wo"]


def _mlp_sharded(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """:func:`apply_mlp` on each rank's shards (module docstring)."""
    from ..parallel import sharding as shd

    bd = shd.layout_of(x).dims[0]
    batch = shd._axes_of(bd)
    f_dim = params["wo"].shape[0]
    ff = shd.tp_axes(batch, f_dim)
    stored = shd._axes_of(shd.layout_of(params["wo"]).dims[0])   # ff as the rules keep it
    sizes = shd.mesh_sizes(shd.sharded_mesh())
    matrices = sum(params[n].dim() == 2 for n in params)
    if set(stored) & set(batch) and x.shape[0] * x.shape[1] <= \
            matrices * f_dim // math.prod(sizes[a] for a in ff):
        # fewer rows than the weight columns a regather would move (a
        # decode): the rows are gathered, the weights stay where they are
        bd, ff = None, stored
    f = shd.entry(ff)
    w_in = {name: shd.Layout((None, f) if name.startswith("wi") else (f, None) if name == "wo"
                             else (f,))
            for name in params if name != "bo"}

    y = shd.local_call(lambda p, xl: _mlp_body(p, xl, cfg), shd.Layout((bd, None, None), ff),
                       (w_in, shd.Layout((bd, None, None))), {n: params[n] for n in w_in}, x)
    y = shd.constrain(y, ("batch", "seq", None))
    return y + params["bo"] if "bo" in params else y


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
