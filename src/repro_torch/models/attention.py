"""Attention block: projections + rope + (self|cross) attention + KV caches.

The port of ``repro/models/attention.py``.  Full-sequence attention goes
through :mod:`repro_torch.kernels.flash_attention.ops`, so the tunable
impl/tile knobs apply, and on the card it runs the Hopper kernel: causal
self-attention, the encoder's non-causal self-attention, and
cross-attention (queries from ``x``, keys and values from a source of
another length: no rope, no mask, no window).

Conventions (as in the reference):
  * activations x: (B, S, d_model); q/k/v: (B, S, H|K, hd)
  * projections keep the reference layouts: wq/wk/wv (d, H|K, hd), wo (H, hd, d)
  * KV cache per layer: dict(k=(B, C, K, hd), v=(B, C, K, hd)); capacity
    C = cfg.cache_len(context) — a ring buffer when C == window.
  * a cross-attention cache holds the projected source (encoder output or
    modal embeddings): filled by prefill, read by decode, never written.

In a sharded program (a sharded mesh active,
:func:`repro_torch.parallel.sharding.use_rules`) both entry points run
their projections, rope, the attention and the output projection on each
rank's shards (:func:`~repro_torch.parallel.sharding.local_call`), with the
reference's layouts:

  * head-parallel where the head count divides ``model`` (the query heads,
    ``wo``'s rows and, where they divide too, the KV heads are the rank's
    own; the sequence is gathered once a layer); the kernel launches on the
    local heads, and where the KV heads do not divide ``model`` (GQA, K/V
    replicated) each rank hands it the KV heads its own query heads read.
    The output projection gives a partial sum over ``model``, reduced into
    the residual's layout;
  * sequence-parallel otherwise (:func:`_heads_or_seq`; hymba's 25 heads):
    each rank attends its own query rows to the gathered K/V, its rows'
    offset passed to the kernel;
  * decode: the KV cache is sequence-sharded over ``model``; each rank
    writes the new token where its slot lies, keeps its local max, sum and
    weighted V, and three all-reduces combine them (a distributed
    flash-decode); the cache is never gathered.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..kernels.flash_attention import ops as attn_ops
from ..kernels.flash_attention import ref as attn_ref
from ..parallel import sharding as shd
from .config import ModelConfig
from .layers import P, rope

__all__ = ["attn_params", "cross_attn_params", "attn_cache_spec", "apply_attn",
           "apply_attn_decode"]


def attn_params(cfg: ModelConfig, cross: bool = False) -> Dict[str, P]:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wo_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    out = {
        "wq": P((d, h, hd), ("d_model", "heads", "head_dim")),
        "wk": P((d, k, hd), ("d_model", "kv_heads", "head_dim")),
        "wv": P((d, k, hd), ("d_model", "kv_heads", "head_dim")),
        "wo": P((h, hd, d), ("heads", "head_dim", "d_model"), scale=wo_scale),
    }
    if cfg.use_bias:
        out["bq"] = P((h, hd), ("heads", "head_dim"), "zeros")
        out["bk"] = P((k, hd), ("kv_heads", "head_dim"), "zeros")
        out["bv"] = P((k, hd), ("kv_heads", "head_dim"), "zeros")
        out["bo"] = P((d,), ("d_model",), "zeros")
    if cfg.qk_norm and not cross:
        out["q_norm"] = P((hd,), ("head_dim",), "ones")
        out["k_norm"] = P((hd,), ("head_dim",), "ones")
    return out


def cross_attn_params(cfg: ModelConfig) -> Dict[str, P]:
    """Cross-attention projections: as self-attention's, never QK-normed."""
    return attn_params(cfg, cross=True)


def attn_cache_spec(cfg: ModelConfig, batch: int, context: int) -> Dict[str, P]:
    """Per-layer KV-cache leaf specs."""
    shape = (batch, cfg.cache_len(context), cfg.n_kv_heads, cfg.hd)
    logical = ("batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": P(shape, logical, "zeros"), "v": P(shape, logical, "zeros")}


def _qk_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) @ (d,N,hd) → contiguous (B,S,N,hd)."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).view(*x.shape[:-1], n, hd)


def _project_qkv(params: Dict[str, torch.Tensor], x: torch.Tensor, src: torch.Tensor,
                 cfg: ModelConfig, positions: Optional[torch.Tensor],
                 k_positions: Optional[torch.Tensor] = None,
                 proj: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None):
    """q from ``x``, k and v from ``src``; rope at ``positions`` on q and at
    ``k_positions`` (default ``positions``) on k (self-attention), or none
    (``positions`` None: cross-attention).  ``proj(t, name)`` projects ``t``
    by ``params[name]`` (default :func:`_proj`; a sharded decode gathers the
    heads its weights' shards give)."""
    proj = proj or (lambda t, name: _proj(t, params[name]))
    q, k, v = proj(x, "wq"), proj(src, "wk"), proj(src, "wv")
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if "q_norm" in params:
        q = _qk_rmsnorm(q, params["q_norm"])
        k = _qk_rmsnorm(k, params["k_norm"])
    if positions is None:
        return q, k, v
    k_positions = positions if k_positions is None else k_positions
    return rope(q, positions, cfg.rope_theta), rope(k, k_positions, cfg.rope_theta), v


def _out(params: Dict[str, torch.Tensor], y: torch.Tensor) -> torch.Tensor:
    h, hd, d = params["wo"].shape
    y = y.reshape(*y.shape[:-2], h * hd) @ params["wo"].reshape(h * hd, d)
    return y + params["bo"] if "bo" in params else y


def apply_attn(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
               xkv: Optional[torch.Tensor] = None, causal: bool = True, q_offset: int = 0):
    """Full-sequence attention (prefill / forward).  Returns (y, (k, v)) so
    prefill can fill the cache.  Self-attention (``xkv`` None) ropes
    positions ``q_offset + 0..S-1`` — every position, a prompt's left pad
    included — under ``causal`` and the config's window.  Cross-attention
    (``xkv`` (B, S_src, d), the encoder output or modal embeddings) projects
    k and v from the source and attends without rope, mask or window."""
    if shd.sharded_mesh() is not None:
        return _attn_sharded(params, x, cfg, xkv, causal, q_offset)
    if xkv is not None:
        q, k, v = _project_qkv(params, x, xkv, cfg, None)
        y = attn_ops.flash_attention(q, k, v, causal=False, window=0, q_offset=q_offset)
        return _out(params, y), (k, v)
    s = x.shape[1]
    pos = q_offset + torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, x, x, cfg, pos)
    q_log = _heads_or_seq(tuple(q.shape), "heads")
    q = shd.constrain(q, q_log)
    k = shd.constrain(k, ("batch", None, "kv_heads", None))
    v = shd.constrain(v, ("batch", None, "kv_heads", None))
    y = attn_ops.flash_attention(q, k, v, causal=causal, window=cfg.window,
                                 q_offset=q_offset)
    y = shd.constrain(y, q_log)
    return _out(params, y), (k, v)


def apply_attn_decode(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,                           # (B, 1, d_model)
    cache: Dict[str, torch.Tensor],
    pos: Union[int, torch.Tensor],             # scalar, or (B,) per-row positions
    cfg: ModelConfig,
    *,
    cross: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token attention against, and update of, a KV cache.

    The new token's K/V go to slot ``pos % C`` of each row (a ring buffer
    when C == window).  ``pos`` is a Python int (gang decode: every row at
    one position) or a ``(B,)`` tensor (continuous batching: each slot at
    its own position, rope phase and validity horizon).  The write updates
    ``cache`` IN PLACE — the reference returns a new cache, but each caller
    rebinds it anyway, and an in-place row write saves copying the whole
    cache every token.

    ``cross``: the cache is a static cross-attention cache (the projected
    source); q (no rope) attends to every one of its C positions, as the
    reference's ``pos = C - 1``, and nothing is written.
    """
    if shd.sharded_mesh() is not None:
        return _decode_sharded(params, x, cache, pos, cfg, cross), cache
    c = cache["k"].shape[1]
    if cross:
        q = _proj(x, params["wq"])
        if "bq" in params:
            q = q + params["bq"]
        q = shd.constrain(q, ("batch", None, None, None))
        y = attn_ops.decode_attention(q, cache["k"], cache["v"], c - 1)
        return _out(params, y), cache
    b = x.shape[0]
    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    positions = (pos[:, None] if per_row
                 else torch.full((1, 1), int(pos), device=x.device, dtype=torch.long))
    q, k, v = _project_qkv(params, x, x, cfg, positions)
    q = shd.constrain(q, ("batch", None, None, None))
    k = shd.constrain(k, ("batch", None, None, None))
    v = shd.constrain(v, ("batch", None, None, None))
    if per_row:
        rows = torch.arange(b, device=x.device)
        slot = pos % c
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    else:
        slot = int(pos) % c
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    y = attn_ops.decode_attention(q, cache["k"], cache["v"], pos, window=cfg.window)
    return _out(params, y), cache


# ------------------------------------------------------------ sharded program
def _heads_or_seq(shape: Tuple[int, ...], heads_name: str) -> tuple:
    """Logical axes for an activation (B, S, H, D): head-parallel if H
    divides the model axis, else sequence-parallel (never replicated)."""
    head_first = ("batch", None, heads_name, None)
    mesh, rules = shd.active_rules()
    if mesh is None or rules is None:
        return head_first
    if shd.spec_for(P(shape, head_first), rules, mesh)[2] is not None:
        return head_first
    return ("batch", "seq", None, None)


def _gathered(t, keep: Tuple[int, ...] = ()) -> shd.Layout:
    """``t``'s stored layout with every dimension but ``keep`` whole (an FSDP
    row gathered, a head-dim fallback replicated)."""
    dims = shd.layout_of(t).dims
    return shd.Layout(tuple(e if i in keep else None for i, e in enumerate(dims)))


def _model_dim(t) -> Optional[int]:
    """The dimension of ``t`` that ``model`` shards, if any."""
    for i, e in enumerate(shd.layout_of(t).dims):
        if "model" in shd._axes_of(e):
            return i
    return None


def _local_kv(k: torch.Tensor, h_local: int, n_heads: int) -> torch.Tensor:
    """The KV heads this rank's query heads read, when K/V are replicated and
    the query heads are the rank's ``h_local`` of ``n_heads``: query head
    ``h`` reads KV head ``h // (H / K)``, offset by the rank's first head."""
    g = n_heads // k.shape[2]
    first = shd.axis_rank("model") * h_local
    if h_local % g and g % h_local:
        raise ValueError(f"{h_local} local query heads do not group over {k.shape[2]} KV heads")
    return k[:, :, first // g:first // g + max(1, h_local // g)].contiguous()


def _attn_sharded(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                  xkv: Optional[torch.Tensor], causal: bool, q_offset: int):
    """:func:`apply_attn` in a sharded program (module docstring)."""
    cross = xkv is not None
    src = xkv if cross else x
    bd = shd.layout_of(x).dims[0]
    n_heads = params["wq"].shape[1]
    q_log = _heads_or_seq((x.shape[0], x.shape[1], n_heads, params["wq"].shape[2]), "heads")
    head_par = q_log[2] is not None
    kv_par = head_par and _model_dim(params["wk"]) == 1
    heads = lambda on: "model" if on else None

    def w_layout(name: str) -> shd.Layout:
        """Each weight's layout in the body: its heads split as the query's
        (K/V's as the KV heads), every other dimension whole."""
        on = heads(kv_par if name in ("wk", "wv", "bk", "bv") else head_par)
        if name in ("wq", "wk", "wv"):
            return shd.Layout((None, on, None))
        if name in ("wo", "bq", "bk", "bv"):
            return shd.Layout((on,) + (None,) * (params[name].dim() - 1))
        return shd.Layout((None,) * params[name].dim())       # q_norm, k_norm

    w_in = {name: w_layout(name) for name in params if name != "bo"}
    wp = {name: params[name] for name in w_in}
    whole = shd.Layout((bd, None, None))
    rows = shd.Layout((bd, "model" if not head_par else None, None))
    window = 0 if cross else cfg.window

    def body(p, xq, xs):
        s_q = xq.shape[1]
        off = q_offset + (0 if head_par else shd.axis_rank("model") * s_q)
        if cross:
            q, k, v = _project_qkv(p, xq, xs, cfg, None)
        else:                                       # own query rows, every key
            q, k, v = _project_qkv(p, xq, xs, cfg, off + torch.arange(s_q, device=xq.device),
                                   q_offset + torch.arange(xs.shape[1], device=xs.device))
        kk, vv = k, v
        if head_par and not kv_par:
            kk, vv = _local_kv(k, q.shape[2], n_heads), _local_kv(v, q.shape[2], n_heads)
        y = attn_ops.flash_attention(q, kk, vv, causal=causal and not cross, window=window,
                                     q_offset=off)
        return _out(p, y), k, v

    y_out = shd.Layout((bd, None, None), ("model",)) if head_par else rows
    kv_out = shd.Layout((bd, None, heads(kv_par), None))
    if head_par and not cross:                      # one gather of the sequence
        y, k, v = shd.local_call(lambda p, xl: body(p, xl, xl), (y_out, kv_out, kv_out),
                                 (w_in, whole), wp, x)
    else:
        y, k, v = shd.local_call(body, (y_out, kv_out, kv_out), (w_in, rows, whole), wp, x,
                                 src)
    k = shd.constrain(k, ("batch", None, "kv_heads", None))
    v = shd.constrain(v, ("batch", None, "kv_heads", None))
    y = shd.constrain(y, ("batch", "seq", None))
    if "bo" in params:
        y = y + params["bo"]
    return y, (k, v)


def _decode_combine(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                    group) -> torch.Tensor:
    """One token against this rank's slots of a sequence-sharded cache,
    combined over ``group``: local max, sum and weighted V, then all-reduces
    (the reference's distributed flash-decode).  ``valid``: (rows or 1,
    local slots)."""
    from torch.distributed import _functional_collectives as funcol

    b, _, h, d = q.shape
    n_kv = k.shape[2]
    s = attn_ref._scores(attn_ref._group_q(q, n_kv), k, 1.0 / math.sqrt(d))   # (b,K,g,1,c)
    s = torch.where(valid[:, None, None, None, :], s, attn_ref._NEG_INF)
    m = funcol.all_reduce(s.amax(-1, keepdim=True), "max", group)
    p = torch.exp(s - m)
    l = funcol.all_reduce(p.sum(-1), "sum", group)                           # (b,K,g,1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    o = funcol.all_reduce(o, "sum", group)
    o = o / l.permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, 1, h, d).to(q.dtype)


def _decode_sharded(params: Dict[str, torch.Tensor], x: torch.Tensor, cache: Dict[str, Any],
                    pos: Union[int, torch.Tensor], cfg: ModelConfig, cross: bool) -> torch.Tensor:
    """:func:`apply_attn_decode` in a sharded program (module docstring):
    the cache is updated in place on each rank's slots; returns the
    attention block's output in the residual's layout."""
    from torch.distributed import _functional_collectives as funcol

    dm = shd.sharded_mesh()
    group = dm.get_group("model") if "model" in dm.mesh_dim_names else None
    bd = shd.layout_of(x).dims[0]
    seq_sharded = _model_dim(cache["k"]) == 1
    c_in = shd.layout_of(cache["k"]) if seq_sharded or not cross else \
        shd.Layout((shd.layout_of(cache["k"]).dims[0], None, None, None))
    names = [n for n in params if n != "bo"]
    w_in = {n: _gathered(params[n], keep=(1, 2) if n in ("wq", "wk", "wv") else
                         (0, 1) if n == "wo" else ())
            for n in names}
    dims = {n: _model_dim(params[n]) for n in ("wq", "wk", "wo")}
    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    pos_in = shd.Layout((bd,)) if per_row else None

    def gather(t, dim):
        if dim is None:
            return t
        with warnings.catch_warnings():      # renamed all_gather_single in later releases
            warnings.simplefilter("ignore", FutureWarning)
            return funcol.all_gather_tensor(t, dim + 1, group)

    def body(p, xl, kc, vc, pl):
        c_loc = kc.shape[1]
        first = shd.axis_rank("model") * c_loc if seq_sharded else 0
        c = c_loc * (dm.size(dm.mesh_dim_names.index("model")) if seq_sharded else 1)
        proj = lambda t, name: gather(_proj(t, p[name]), dims["wk" if name == "wv" else name])
        if cross:
            q = proj(xl, "wq")
            if "bq" in p:
                q = q + p["bq"]
            valid = torch.ones((1, c_loc), dtype=torch.bool, device=xl.device)
        else:
            if not per_row:                           # gang decode: every row at one position
                pl = torch.full((xl.shape[0],), int(pl), dtype=torch.long, device=xl.device)
            pr = pl[:, None]
            q, k, v = _project_qkv(p, xl, xl, cfg, pr, proj=proj)
            slot = pl % c - first                    # the new token's slot among this rank's
            here = ((slot >= 0) & (slot < c_loc))[:, None, None]
            at, rows = slot.clamp(0, c_loc - 1), torch.arange(kc.shape[0], device=xl.device)
            for cache_t, new in ((kc, k), (vc, v)):
                cache_t[rows, at] = torch.where(here, new[:, 0].to(cache_t.dtype),
                                                cache_t[rows, at])
            valid = first + torch.arange(c_loc, device=xl.device)[None, :] <= pr
            if cfg.window and cfg.window == c:
                valid = valid | (pr >= c)
        if seq_sharded:
            y = _decode_combine(q, kc, vc, valid, group)
        else:
            y = attn_ops.decode_attention(q, kc, vc, c - 1 if cross else pl,
                                          window=0 if cross else cfg.window)
        wo_dim = dims["wo"]
        if wo_dim is not None:                        # this rank's heads (or head-dim chunk)
            n = p["wo"].shape[wo_dim]
            start = shd.axis_rank("model") * n
            y = y.narrow(2 + wo_dim, start, n)
        return _out(p, y)

    y = shd.local_call(body, shd.Layout((bd, None, None),
                                        ("model",) if dims["wo"] is not None else ()),
                       ({n: w_in[n] for n in names}, shd.Layout((bd, None, None)), c_in, c_in,
                        pos_in),
                       {n: params[n] for n in names}, x, cache["k"], cache["v"], pos)
    y = shd.constrain(y, ("batch", "seq", None))
    if "bo" in params:
        y = y + params["bo"]
    return y
