"""Mamba-2 (SSD) mixer block, built on :mod:`repro_torch.kernels.ssd`.

The port of ``repro/models/ssm.py``.  Layout as in the reference: an input
projection producing (z, x, B, C, dt), a causal depthwise conv over the
(x, B, C) channels, the SSD state-space core, a gated RMSNorm and an output
projection.  Parameters are separate leaves (wz/wx/wB/wC/wdt).  The prefill
SSD goes through :func:`repro_torch.kernels.ssd.ops.ssd`, so on the card it
runs the Hopper kernel; decode is the plain one-token update.

Decode state per layer:
  * conv:  (B, conv_k-1, H*P + 2*G*N)  — the last inputs of the conv channels
  * ssd:   (B, H, P, N)                — the SSM state, float32
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd import ops as ssd_ops
from .config import ModelConfig
from .layers import P

__all__ = ["ssm_params", "ssm_state_spec", "apply_ssm", "apply_ssm_decode"]


def ssm_params(cfg: ModelConfig) -> Dict[str, P]:
    d = cfg.d_model
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    ck = cfg.ssm_conv
    wo_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "wz": P((d, h, p), ("d_model", "ssm_heads", "ssm_head_dim")),
        "wx": P((d, h, p), ("d_model", "ssm_heads", "ssm_head_dim")),
        "wB": P((d, g, n), ("d_model", "ssm_groups", "ssm_state")),
        "wC": P((d, g, n), ("d_model", "ssm_groups", "ssm_state")),
        "wdt": P((d, h), ("d_model", "ssm_heads")),
        "conv_x": P((ck, h, p), ("conv_k", "ssm_heads", "ssm_head_dim"), "normal", scale=0.5),
        "conv_B": P((ck, g, n), ("conv_k", "ssm_groups", "ssm_state"), "normal", scale=0.5),
        "conv_C": P((ck, g, n), ("conv_k", "ssm_groups", "ssm_state"), "normal", scale=0.5),
        "A_log": P((h,), ("ssm_heads",), "ssm_a", dtype="float32"),
        "dt_bias": P((h,), ("ssm_heads",), "ssm_dt", dtype="float32"),
        "D": P((h,), ("ssm_heads",), "ones"),
        "norm_scale": P((h, p), ("ssm_heads", "ssm_head_dim"), "ones"),
        "wo": P((h, p, d), ("ssm_heads", "ssm_head_dim", "d_model"), scale=wo_scale),
    }


def ssm_state_spec(cfg: ModelConfig, batch: int) -> Dict[str, P]:
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    conv_ch = h * p + 2 * g * n
    return {
        "conv": P((batch, cfg.ssm_conv - 1, conv_ch), ("batch", None, "ssm_channels"), "zeros"),
        "ssd": P((batch, h, p, n), ("batch", "ssm_heads", "ssm_head_dim", "ssm_state"),
                 "zeros", dtype="float32"),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv as the reference's shifted multiply-adds (in u's
    dtype), then SiLU in f32. u: (B, S, C); w: (K, C); prev: (B, K-1, C)."""
    k, s = w.shape[0], u.shape[1]
    if prev is None:
        prev = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    up = torch.cat([prev.to(u.dtype), u], dim=1)                       # (B, S+K-1, C)
    out = up[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + up[:, i:i + s] * w[i]
    return F.silu(out.float()).to(u.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm(y * silu(z)) * scale over the head dim. y/z: (..., H, P)."""
    yf = y.float() * F.silu(z.float())
    r = torch.rsqrt(yf.square().mean(-1, keepdim=True) + eps)
    return (yf * r * scale.float()).to(y.dtype)


def _split_conv_channels(cfg: ModelConfig, uc: torch.Tensor):
    """(…, H*P + 2*G*N) → contiguous x (…, H, P), B and C (…, G, N)."""
    h, p, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    lead = uc.shape[:-1]
    hx = uc[..., : h * p].reshape(*lead, h, p).contiguous()
    b = uc[..., h * p: h * p + g * n].reshape(*lead, g, n).contiguous()
    c = uc[..., h * p + g * n:].reshape(*lead, g, n).contiguous()
    return hx, b, c


def _conv_input(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig):
    """z (…, H, P), dt (…, H) and the conv's input channels u = (x | B | C)
    with its weights (K, channels)."""
    d, k = cfg.d_model, cfg.ssm_conv
    z = (x @ params["wz"].reshape(d, -1)).view(*x.shape[:-1], cfg.ssm_heads, cfg.ssm_head_dim)
    dt = x @ params["wdt"]
    u = torch.cat([x @ params[w].reshape(d, -1) for w in ("wx", "wB", "wC")], dim=-1)
    conv_w = torch.cat([params[w].reshape(k, -1) for w in ("conv_x", "conv_B", "conv_C")],
                       dim=-1)
    return z, dt, u, conv_w


def _ssd_inputs(params: Dict[str, torch.Tensor], dt: torch.Tensor):
    """softplus(dt + dt_bias) and A = -exp(A_log), both f32; D as f32."""
    dtp = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["A_log"].float())
    return dtp, a, params["D"].float()


def apply_ssm(params: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence mixer from a zero state (the port's prefill and forward
    never continue one).  x (B, S, d) → (B, S, d) and the decode state
    {"conv": the last conv_k-1 inputs, "ssd": the final SSD state}."""
    z, dt, u, conv_w = _conv_input(params, x, cfg)
    xs, bs, cs = _split_conv_channels(cfg, _causal_conv(u, conv_w))
    dtp, a, d = _ssd_inputs(params, dt)
    y, state = ssd_ops.ssd(xs, dtp, a, bs, cs, d, return_state=True)
    y = _gated_norm(y, z, params["norm_scale"])
    out = y.reshape(*y.shape[:2], -1) @ params["wo"].reshape(-1, cfg.d_model)
    hist = cfg.ssm_conv - 1
    conv = u[:, -hist:]
    if conv.shape[1] < hist:  # short prefill: left-pad the history
        pad = torch.zeros((u.shape[0], hist - conv.shape[1], u.shape[2]), dtype=u.dtype,
                          device=u.device)
        conv = torch.cat([pad, conv], dim=1)
    return out, {"conv": conv, "ssd": state}


def apply_ssm_decode(params: Dict[str, torch.Tensor], x: torch.Tensor,
                     state: Dict[str, torch.Tensor], cfg: ModelConfig,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token. x (B, 1, d) → (B, 1, d) and ``state``, whose {"conv",
    "ssd"} tensors now hold the new state.  They are written IN PLACE (the
    reference returns new arrays), as the K/V rows are, so a captured decode
    step reads and writes the same buffers at every replay."""
    z, dt, u, conv_w = _conv_input(params, x, cfg)                 # u: (B, 1, C)
    uc = _causal_conv(u, conv_w, state["conv"])
    new_conv = torch.cat([state["conv"].to(u.dtype), u], dim=1)[:, 1:]
    xs1, bs1, cs1 = _split_conv_channels(cfg, uc[:, 0])
    dtp, a, d = _ssd_inputs(params, dt[:, 0])
    y, ssd_state = ssd_ops.ssd_decode_step(state["ssd"], xs1, dtp, a, bs1, cs1, d)
    y = _gated_norm(y, z[:, 0], params["norm_scale"])
    out = y.reshape(y.shape[0], -1) @ params["wo"].reshape(-1, cfg.d_model)
    state["conv"].copy_(new_conv)
    state["ssd"].copy_(ssd_state)
    return out[:, None], state
