"""Plain float32 forward, loss and AdamW of the dense and MoE decoders.

The layer equations are those of the configuration file's ``program``
section, which states the model as the port runs it (the departures from the
published model are listed in that file):

  * embedding lookup; per layer: norm → self-attention (q, k, v projections,
    QK-norm per head where stated, rotary embedding on the two halves of the
    head dim, causal softmax over every earlier position, output
    projection) → residual; norm → SwiGLU MLP, or a top-k router (float32
    softmax over the experts, a stable descending sort, the k gates
    renormalised) and the k SwiGLU experts a token chose, with no capacity
    limit → residual; final norm; logits over the vocabulary through the
    output projection (the embedding table when tied);
  * ``layernorm_np``: LayerNorm without scale or bias; ``rmsnorm``: x times
    rsqrt(mean(x²) + eps) times its scale.

Weights are the raw tensors the benchmark drew, stacked along a leading
layer axis and named as the port's parameter tree names them, read in
float32 a layer at a time.  Both operands of every product with a weight go
through a precision (``prec``): :data:`EXACT` for the reference leaves them
as they are; a control rounds them lower (``prec.w(t, axes)``, ``axes`` the
weight's contracted dimensions; ``prec.x(t)``, the activation, contracted
on its last).  TF32 must be off (:func:`strict_f32`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F


class Exact:
    """The reference's precision: every operand as it is, in float32."""

    def w(self, t: torch.Tensor, axes: Tuple[int, ...]) -> torch.Tensor:
        return t

    def x(self, t: torch.Tensor) -> torch.Tensor:
        return t


EXACT = Exact()


def strict_f32() -> None:
    """float32 products in full float32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass(frozen=True)
class RefConfig:
    name: str
    family: str               # dense | moe
    n_layers: int
    d: int
    n_heads: int
    n_kv_heads: int
    hd: int
    d_ff: int                 # the MLP's width, or one expert's
    vocab: int
    norm: str                 # layernorm_np | rmsnorm
    rope_theta: float
    tie: bool
    qk_norm: bool = False
    n_experts: int = 0
    top_k: int = 0
    window: int = 0
    norm_eps: float = 1e-5
    qk_norm_eps: float = 1e-6

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab + 255) // 256) * 256

    @classmethod
    def from_file(cls, spec: Dict[str, Any]) -> "RefConfig":
        """From a configuration file's ``program`` section."""
        p = spec["program"]
        moe = p["family"] == "moe"
        return cls(name=spec["name"], family=p["family"], n_layers=p["n_layers"], d=p["d_model"],
                   n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
                   hd=p.get("head_dim") or p["d_model"] // p["n_heads"],
                   d_ff=p["moe_d_ff"] if moe else p["d_ff"], vocab=p["vocab_size"],
                   norm=p["norm"], rope_theta=float(p["rope_theta"]),
                   tie=bool(p.get("tie_embeddings", False)), qk_norm=bool(p.get("qk_norm", False)),
                   n_experts=p.get("moe_num_experts", 0), top_k=p.get("moe_top_k", 0),
                   window=p.get("window", 0))


def _norm(x: torch.Tensor, scale, m: RefConfig) -> torch.Tensor:
    if m.norm == "rmsnorm":
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + m.norm_eps) * scale
    mu = x.mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt((x - mu).square().mean(-1, keepdim=True) + m.norm_eps)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D), the two halves of D rotated by pos × theta^(−i/half)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                      device=x.device) / half)
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer_weights(w: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l`` of every stacked block leaf, as float32."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[l].float()
    return take(w["blocks"])


def _attention(a: Dict[str, torch.Tensor], x: torch.Tensor, m: RefConfig, prec) -> torch.Tensor:
    t = x.shape[0]
    xq = prec.x(x)

    def proj(name: str, n: int) -> torch.Tensor:
        return (xq @ prec.w(a[name], (0,)).reshape(m.d, n * m.hd)).view(t, n, m.hd)

    q, k, v = proj("wq", m.n_heads), proj("wk", m.n_kv_heads), proj("wv", m.n_kv_heads)
    if m.qk_norm:
        q = q * torch.rsqrt(q.square().mean(-1, keepdim=True) + m.qk_norm_eps) * a["q_norm"]
        k = k * torch.rsqrt(k.square().mean(-1, keepdim=True) + m.qk_norm_eps) * a["k_norm"]
    pos = torch.arange(t, device=x.device)
    q, k = _rope(q, pos, m.rope_theta), _rope(k, pos, m.rope_theta)
    g = m.n_heads // m.n_kv_heads
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(m.hd)
    keep = pos[None, :] <= pos[:, None]
    if m.window:
        keep = keep & (pos[:, None] - pos[None, :] < m.window)
    p = torch.softmax(torch.where(keep, s, torch.finfo(s.dtype).min), dim=-1)
    y = torch.einsum("hqk,khd->qhd", p, v).reshape(t, m.n_heads * m.hd)
    return prec.x(y) @ prec.w(a["wo"], (0, 1)).reshape(m.n_heads * m.hd, m.d)


def _swiglu(w: Dict[str, torch.Tensor], x: torch.Tensor, prec) -> torch.Tensor:
    xq = prec.x(x)
    h = F.silu(xq @ prec.w(w["wi_gate"], (0,))) * (xq @ prec.w(w["wi_up"], (0,)))
    return prec.x(h) @ prec.w(w["wo"], (0,))


def route(router: torch.Tensor, x: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (T, k), expert ids (T, k)): the top k of the float32 softmax of
    ``x @ router``, ties to the lower id, gates renormalised over the k."""
    probs = torch.softmax(x @ router, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :top_k]
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), ids[:, :top_k]


def _moe(e: Dict[str, torch.Tensor], x: torch.Tensor, m: RefConfig, prec) -> torch.Tensor:
    gates, ids = route(prec.w(e["router"], (0,)), prec.x(x), m.top_k)
    y = torch.zeros_like(x)
    for j in range(m.n_experts):
        hit = ids == j                                     # (T, k): at most one per row
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        gate = (gates * hit)[rows].sum(-1, keepdim=True)
        out = _swiglu({k: e[k][j] for k in ("wi_gate", "wi_up", "wo")}, x[rows], prec)
        y = y.index_add(0, rows, gate * out)
    return y


def hidden(w: Dict[str, Any], m: RefConfig, tokens: torch.Tensor, prec=EXACT) -> torch.Tensor:
    """tokens (T,) → the final normed hidden states (T, d), float32."""
    x = prec.w(w["embed"].float(), (1,))[tokens]
    for l in range(m.n_layers):
        lw = _layer_weights(w, l)
        x = x + _attention(lw["attn"], _norm(x, lw["ln1"].get("scale"), m), m, prec)
        xn = _norm(x, lw["ln2"].get("scale"), m)
        if m.family == "moe":
            x = x + _moe(lw["moe"], xn, m, prec)
        else:
            x = x + _swiglu(lw["mlp"], xn, prec)
    scale = w["ln_f"]["scale"].float() if "scale" in w["ln_f"] else None
    return _norm(x, scale, m)


def head(w: Dict[str, Any], m: RefConfig, h: torch.Tensor, prec=EXACT) -> torch.Tensor:
    """Logits (T, vocab) of final hidden states."""
    if m.tie:
        return prec.x(h) @ prec.w(w["embed"].float(), (1,))[:m.vocab].T
    return prec.x(h) @ prec.w(w["out"].float(), (0,))[:, :m.vocab]


def logits(w: Dict[str, Any], m: RefConfig, tokens: torch.Tensor, prec=EXACT) -> torch.Tensor:
    """tokens (T,) → logits (T, vocab), float32."""
    return head(w, m, hidden(w, m, tokens, prec), prec)


def nll_sum(w: Dict[str, Any], m: RefConfig, tokens: torch.Tensor, labels: torch.Tensor,
            prec=EXACT) -> torch.Tensor:
    """Summed next-token cross-entropy of one row (labels −1 are left out)."""
    lg = logits(w, m, tokens, prec)
    keep = labels >= 0
    return F.cross_entropy(lg[keep], labels[keep], reduction="sum")


# ------------------------------------------------------------------ AdamW
@dataclasses.dataclass(frozen=True)
class Hyper:
    """AdamW and its schedule as the cell pins them (``warmup_cosine``)."""
    base_lr: float
    warmup: int
    total: int
    weight_decay: float
    clip_norm: float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    def lr(self, step: int) -> float:
        """``warmup_cosine`` at 0-based ``step``, min_frac 0.1."""
        if step < self.warmup:
            return self.base_lr * step / max(self.warmup, 1)
        prog = min(max((step - self.warmup) / max(self.total - self.warmup, 1), 0.0), 1.0)
        return self.base_lr * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def adamw_step(params, grads, m, v, step: int, hp: Hyper) -> None:
    """One AdamW step in float32 over lists of tensors, in place: the global
    norm clipped to ``clip_norm``, the moments, bias correction and
    decoupled weight decay."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(hp.clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
    lr, count = hp.lr(step), step + 1
    bc1, bc2 = 1.0 - hp.b1 ** count, 1.0 - hp.b2 ** count
    for p, g, mm, vv in zip(params, grads, m, v):
        g = g * scale
        mm.mul_(hp.b1).add_((1.0 - hp.b1) * g)
        vv.mul_(hp.b2).add_((1.0 - hp.b2) * g * g)
        p.sub_(lr * ((mm / bc1) / (torch.sqrt(vv / bc2) + hp.eps) + hp.weight_decay * p))
