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

In a sharded program the mixer runs on each rank's SSM heads, or where the
heads do not divide ``model`` (hymba: 25) on its slice of the head dim (SSD
is linear in it): the projections, the depthwise conv and the SSD kernel
on local shards with the sequence gathered once, the gated norm in the
heads' layout, the output projection a partial sum over ``model``.  Decode
updates each rank's SSD state in place; the small conv state is gathered
and written back.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd import ops as ssd_ops
from ..parallel import sharding as shd
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


def _split_conv_channels(params: Dict[str, torch.Tensor], uc: torch.Tensor):
    """(…, H*P + 2*G*N) → contiguous x (…, H, P), B and C (…, G, N), at the
    sizes of ``params`` (a sharded program's local shards included)."""
    h, p = params["wx"].shape[1:]
    g, n = params["wB"].shape[1:]
    lead = uc.shape[:-1]
    hx = uc[..., : h * p].reshape(*lead, h, p).contiguous()
    b = uc[..., h * p: h * p + g * n].reshape(*lead, g, n).contiguous()
    c = uc[..., h * p + g * n:].reshape(*lead, g, n).contiguous()
    return hx, b, c


def _conv_input(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """z (…, H, P), dt (…, H) and the conv's input channels u = (x | B | C)
    with its weights (K, channels), every size from ``params``."""
    d, k = x.shape[-1], params["conv_x"].shape[0]
    z = (x @ params["wz"].reshape(d, -1)).view(*x.shape[:-1], *params["wz"].shape[1:])
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


def apply_ssm(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              return_state: bool = True) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence mixer from a zero state (the port's prefill and forward
    never continue one).  x (B, S, d) → (B, S, d) and the decode state
    {"conv": the last conv_k-1 inputs, "ssd": the final SSD state}, or None
    without ``return_state`` (training keeps no decode state)."""
    if shd.sharded_mesh() is not None:
        return _ssm_sharded(params, x, cfg, return_state)
    z, dt, u, conv_w = _conv_input(params, x)
    xs, bs, cs = _split_conv_channels(params, _causal_conv(u, conv_w))
    xs = shd.constrain(xs, ("batch", None, "ssm_heads", "ssm_head_dim"))
    bs = shd.constrain(bs, ("batch", None, None, None))
    cs = shd.constrain(cs, ("batch", None, None, None))
    dt = shd.constrain(dt, ("batch", None, "ssm_heads"))
    dtp, a, d = _ssd_inputs(params, dt)
    y = ssd_ops.ssd(xs, dtp, a, bs, cs, d, return_state=return_state)
    y, state = y if return_state else (y, None)
    y = _gated_norm(y, z, params["norm_scale"])
    out = y.reshape(*y.shape[:2], -1) @ params["wo"].reshape(-1, cfg.d_model)
    if not return_state:
        return out, None
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
    if shd.sharded_mesh() is not None:
        return _ssm_decode_sharded(params, x, state, cfg), state
    z, dt, u, conv_w = _conv_input(params, x)                 # u: (B, 1, C)
    uc = _causal_conv(u, conv_w, state["conv"])
    new_conv = torch.cat([state["conv"].to(u.dtype), u], dim=1)[:, 1:]
    xs1, bs1, cs1 = _split_conv_channels(params, uc[:, 0])
    dtp, a, d = _ssd_inputs(params, dt[:, 0])
    y, ssd_state = ssd_ops.ssd_decode_step(state["ssd"], xs1, dtp, a, bs1, cs1, d)
    y = _gated_norm(y, z[:, 0], params["norm_scale"])
    out = y.reshape(y.shape[0], -1) @ params["wo"].reshape(-1, cfg.d_model)
    state["conv"].copy_(new_conv)
    state["ssd"].copy_(ssd_state)
    return out[:, None], state


# ------------------------------------------------------------ sharded program
_HEADS = ("wz", "wx", "wdt", "conv_x", "A_log", "dt_bias", "D", "norm_scale", "wo")


def _ssm_layouts(params: Dict[str, torch.Tensor], cfg: ModelConfig):
    """(which of heads (``"h"``) or head dim (``"p"``) ``model`` splits, or
    None; each parameter's layout inside the local bodies)."""
    sizes = shd.mesh_sizes(shd.sharded_mesh())
    m = sizes.get("model", 1)
    split = ("h" if cfg.ssm_heads % m == 0 else "p" if cfg.ssm_head_dim % m == 0 else None) \
        if m > 1 else None
    on = lambda axis: "model" if split == axis else None
    lay = {"wz": (None, on("h"), on("p")), "wx": (None, on("h"), on("p")),
           "conv_x": (None, on("h"), on("p")), "norm_scale": (on("h"), on("p")),
           "wo": (on("h"), on("p"), None), "wdt": (None, on("h")), "A_log": (on("h"),),
           "dt_bias": (on("h"),), "D": (on("h"),)}
    return split, {n: shd.Layout(lay.get(n, (None,) * params[n].dim())) for n in params}


def _out_proj(params: Dict[str, torch.Tensor], y: torch.Tensor, bd, split,
              lays) -> torch.Tensor:
    """The gated-normed heads through ``wo``: a partial sum over ``model``
    where it splits them, reduced into the residual's layout."""
    y_lay = shd.Layout((bd, None, "model" if split == "h" else None,
                        "model" if split == "p" else None))

    def body(yl, wo):
        return yl.reshape(*yl.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])

    out = shd.local_call(body, shd.Layout((bd, None, None), ("model",) if split else ()),
                         (y_lay, lays["wo"]), y, params["wo"])
    return shd.constrain(out, ("batch", "seq", None))


def _conv_state(hx: torch.Tensor, hbc: torch.Tensor) -> torch.Tensor:
    """The conv history (B, K-1, H·P + 2·G·N) in the state's layout, from the
    heads' part (B, K-1, H, P) and the B/C channels' (B, K-1, 2·G·N)."""
    hx = shd.constrain(hx, ("batch", None, None, None))
    u = torch.cat([hx.reshape(*hx.shape[:2], -1), hbc], dim=-1)
    return shd.constrain(u, ("batch", None, "ssm_channels"))


def _ssm_sharded(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                 return_state: bool):
    """:func:`apply_ssm` in a sharded program (module docstring)."""
    split, lays = _ssm_layouts(params, cfg)
    bd = shd.layout_of(x).dims[0]
    hist = cfg.ssm_conv - 1
    heads = shd.Layout((bd, None, "model" if split == "h" else None,
                        "model" if split == "p" else None))

    def body(p, xl):
        z, dt, u, conv_w = _conv_input(p, xl)
        xs, bs, cs = _split_conv_channels(p, _causal_conv(u, conv_w))
        dtp, a, d = _ssd_inputs(p, dt)
        y, state = ssd_ops.ssd(xs, dtp, a, bs, cs, d, return_state=True)
        conv = u[:, -hist:]
        if conv.shape[1] < hist:
            conv = torch.cat([conv.new_zeros((u.shape[0], hist - conv.shape[1], u.shape[2])),
                              conv], dim=1)
        nx = xs.shape[2] * xs.shape[3]
        return (y, z, state, conv[..., :nx].reshape(*conv.shape[:2], *xs.shape[2:]),
                conv[..., nx:])

    state_lay = shd.Layout((bd, heads.dims[2], heads.dims[3], None))
    y, z, ssd_state, hx, hbc = shd.local_call(
        body, (heads, heads, state_lay, shd.Layout((bd, None, *heads.dims[2:])),
               shd.Layout((bd, None, None))),
        ({n: lays[n] for n in params}, shd.Layout((bd, None, None))), params, x)
    out = _out_proj(params, _gated_norm(y, z, params["norm_scale"]), bd, split, lays)
    if not return_state:
        return out, None
    ssd_state = shd.constrain(ssd_state, ("batch", "ssm_heads", "ssm_head_dim", "ssm_state"))
    return out, {"conv": _conv_state(hx, hbc), "ssd": ssd_state}


def _ssm_decode_sharded(params: Dict[str, torch.Tensor], x: torch.Tensor,
                        state: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """:func:`apply_ssm_decode` in a sharded program: the SSD state is
    updated in place on each rank's shard, the conv state gathered, advanced
    and written back in its layout."""
    split, lays = _ssm_layouts(params, cfg)
    bd = shd.layout_of(x).dims[0]
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    heads = shd.Layout((bd, None, "model" if split == "h" else None,
                        "model" if split == "p" else None))

    def body(p, xl, conv_full, ssd_state):
        z, dt, u, conv_w = _conv_input(p, xl)                   # u: (B, 1, local C)
        hl, pl = p["wx"].shape[1:]
        r = shd.axis_rank("model")
        prev_x = conv_full[..., :h * pd].reshape(*conv_full.shape[:2], h, pd)
        prev_x = prev_x[:, :, r * hl:(r + 1) * hl] if split == "h" else \
            prev_x[..., r * pl:(r + 1) * pl] if split == "p" else prev_x
        prev = torch.cat([prev_x.reshape(*prev_x.shape[:2], -1), conv_full[..., h * pd:]], -1)
        uc = _causal_conv(u, conv_w, prev)
        xs1, bs1, cs1 = _split_conv_channels(p, uc[:, 0])
        dtp, a, d = _ssd_inputs(p, dt[:, 0])
        y, new = ssd_ops.ssd_decode_step(ssd_state, xs1, dtp, a, bs1, cs1, d)
        ssd_state.copy_(new)
        nx = hl * pl
        return y[:, None], z, u[..., :nx].reshape(*u.shape[:2], hl, pl), u[..., nx:]

    y, z, ux, ubc = shd.local_call(
        body, (heads, heads, shd.Layout((bd, None, *heads.dims[2:])), shd.Layout((bd, None, None))),
        ({n: lays[n] for n in params}, shd.Layout((bd, None, None)),
         shd.Layout((bd, None, None)), shd.layout_of(state["ssd"])),
        params, x, state["conv"], state["ssd"])
    out = _out_proj(params, _gated_norm(y, z, params["norm_scale"]), bd, split, lays)
    new_conv = torch.cat([shd.constrain(state["conv"], ("batch", None, None))[:, 1:],
                          shd.constrain(_conv_state(ux, ubc), ("batch", None, None))], dim=1)
    state["conv"].copy_(shd.constrain(new_conv, ("batch", None, "ssm_channels")))
    return out
