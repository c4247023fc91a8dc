"""Mixture-of-Experts layer: top-k router + capacity-based sparse dispatch.

The port of ``repro/models/moe.py`` on one device.  Dispatch strategies
(the ``torch_moe_dispatch`` component's ``strategy``):

  * ``gather``   — capacity dispatch: each (token, choice) assignment takes
    its rank among the earlier assignments to the same expert (token-major
    order); ranks at or beyond the capacity go to a trash slot, the kept
    ones into an (E, C, d) buffer, a batched per-expert SwiGLU runs over the
    buffer, and each token sums its k results weighted by the gate (0 for a
    dropped one).
  * ``local_tp`` — the reference's shard_map body: without a sharded mesh
    the same values as ``gather``, so the same body here.
  * ``dense``    — every token through every expert, masked combine: the
    exact no-drop oracle.
  * ``auto``     — ``gather`` (the reference's choice without a mesh).

In a sharded program ``auto`` and ``local_tp`` run :func:`_moe_shard_map`
(the reference's ``_moe_shard_map`` as a ``local_map``): the batch goes on
the largest prefix of (``pod``, ``data``) that divides it, the expert
weights are split along ff over ``model`` plus every data axis that
carries no batch rows (the rest all-gathered once at the boundary), each
rank runs the capacity dispatch on its own tokens (a capacity of its
tokens, GShard's per-group semantics), and its partial sum over the ff
shards is reduced into the residual's layout; ``aux`` is averaged over
every axis.  The tokens are the same on every rank of the ff axes: the
sequence is gathered over ``model`` when ``model`` splits ff.  (The
reference keeps the sequence on ``model`` there too and sums expert
outputs of different tokens across ``model``; ROADMAP, faults.)
``gather`` and ``dense`` run the same local body with their own dispatch.

Every shape follows from (T, E, k, capacity factor) and nothing reads a
value back to the host: no ``nonzero``, boolean-mask indexing, ``bincount``
or ``.item()``.  So a MoE prefill or decode step captures as a CUDA graph,
and pad tokens of a left-padded prompt route and take capacity like any
other, as in the reference.  Capacity couples the rows of a batch: a
token's output depends on the tokens ahead of it in the batch.

Numerics kept from the reference:

  * the router runs in float32 (TF32 must be off for float32 products on
    the card, PyTorch's default);
  * ties among the router's probabilities go to the lower expert id, as
    ``jax.lax.top_k`` gives them: a stable descending sort, not ``topk``;
  * the combine adds each token's k contributions one at a time, in k
    order, in x's dtype (the reference's scatter-add), with no atomics;
    the token replica is a broadcast, so its gradient is an ordered sum
    over k.  The one duplicate gather row, a dropped assignment read at
    slot ``cap - 1``, carries a zero weight.

The expert products are ``torch.bmm`` calls: the reference computes them
outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.configstore import bucket_pow2
from ..core.registry import MetricSpec, tunable_component
from ..core.tunable import Categorical, Float
from ..parallel import sharding as shd
from .config import ModelConfig
from .layers import P

__all__ = ["moe_params", "apply_moe", "moe_settings", "MoeSettings", "router_aux_loss",
           "workload_signature", "capacity", "dispatch_plan", "dropped_frac", "STRATEGIES"]

STRATEGIES = ("auto", "local_tp", "gather", "dense")


@tunable_component(
    name="torch_moe_dispatch",
    tunables=(
        Categorical("strategy", default="auto", choices=STRATEGIES,
                    description="auto: gather on one device (the reference's choice "
                                "without a mesh)"),
        Float("capacity_factor", default=1.25, low=1.0, high=4.0,
              description="expert buffer slack over perfect balance"),
    ),
    metrics=(MetricSpec("dropped_frac", "d"), MetricSpec("time_us", "d")),
)
class MoeSettings:
    pass


moe_settings = MoeSettings()


def workload_signature(tokens: int, n_experts: int, top_k: int) -> str:
    """Bucketed token count × routing shape: capacity_factor trades dropped
    tokens against padded expert slots, and the right trade moves with
    tokens-per-expert — a (t=1k, E=8) batch and a (t=32k, E=64) batch are
    different workloads."""
    return f"t{bucket_pow2(tokens)}e{n_experts}k{top_k}"


def moe_params(cfg: ModelConfig) -> Dict[str, P]:
    d, e, f = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    wo_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "router": P((d, e), ("d_model", "experts_router")),
        "wi_gate": P((e, d, f), ("experts", "d_model", "expert_ff")),
        "wi_up": P((e, d, f), ("experts", "d_model", "expert_ff")),
        "wo": P((e, f, d), ("experts", "expert_ff", "d_model"), scale=wo_scale),
    }


def capacity(tokens: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots per expert: ``max(k, ceil(cf·T·k/E))``."""
    return int(max(top_k, math.ceil(capacity_factor * tokens * top_k / n_experts)))


def _onehot(ids: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """One-hot by comparison with ``arange`` (``F.one_hot`` checks its values
    with a host read off the card)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _route(params: Dict[str, torch.Tensor], x2d: torch.Tensor,
           cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (gates (T,k) f32, expert_ids (T,k) int64, probs (T,E) f32).
    A stable descending sort keeps the lower id first among equal
    probabilities, as ``jax.lax.top_k`` does."""
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    gates, ids = vals[:, :k], ids[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)  # renormalize over top-k
    return gates, ids, probs


def router_aux_loss(probs: torch.Tensor, ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e f_e * p_e."""
    counts = _onehot(ids.reshape(-1), n_experts, torch.float32).sum(0)
    frac_tokens = counts / torch.clamp(counts.sum(), min=1.0)
    frac_probs = probs.mean(dim=0)
    return n_experts * torch.sum(frac_tokens * frac_probs)


def _expert_ffn(params: Dict[str, torch.Tensor], xe: torch.Tensor) -> torch.Tensor:
    """Batched per-expert SwiGLU. xe: (E, C, d) -> (E, C, d)."""
    h = F.silu(torch.bmm(xe, params["wi_gate"])) * torch.bmm(xe, params["wi_up"])
    return torch.bmm(h, params["wo"])


def dispatch_plan(ids: torch.Tensor, n_experts: int,
                  cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flat expert ids (T·k,), keep mask, slot) of the (token, choice)
    assignments in token-major order: the rank of an assignment is the
    number of earlier ones to its expert (an exclusive cumsum of the
    one-hot); a rank at or past ``cap`` goes to the trash slot ``cap``.
    The one-hot is laid out (E, T·k), so the cumsum runs along the last
    axis: along the first, the card scans T·k rows one after another in
    only E threads."""
    flat_ids = ids.reshape(-1)
    experts = torch.arange(n_experts, device=ids.device)[:, None]
    onehot = (flat_ids[None] == experts).to(torch.int32)                    # (E, T·k)
    rank = torch.gather(torch.cumsum(onehot, dim=1) - onehot, 0, flat_ids[None])[0]
    keep = rank < cap
    return flat_ids, keep, torch.where(keep, rank, torch.full_like(rank, cap))


def _gather_dispatch(params: Dict[str, torch.Tensor], x2d: torch.Tensor, gates: torch.Tensor,
                     ids: torch.Tensor, cap: int) -> torch.Tensor:
    """The capacity dispatch, expert FFN and ordered combine (module
    docstring) for one device's tokens."""
    t, d = x2d.shape
    e, k = params["wi_gate"].shape[0], ids.shape[1]
    flat_ids, keep, slot = dispatch_plan(ids, e, cap)
    x_rep = x2d.unsqueeze(1).expand(t, k, d).reshape(t * k, d)
    buf = x2d.new_zeros((e, cap + 1, d))
    buf = buf.index_put((flat_ids, slot), x_rep)          # the trash slot is never read
    buf = shd.constrain(buf, ("experts", "capacity", None))
    ye = _expert_ffn(params, buf[:, :cap])                # (E, C, d)
    ye = shd.constrain(ye, ("experts", "capacity", None))
    w = torch.where(keep, gates.reshape(-1), torch.zeros_like(gates.reshape(-1))).to(x2d.dtype)
    yk = ye[flat_ids, torch.clamp(slot, max=cap - 1)]     # (T·k, d)
    contrib = (yk * w[:, None]).view(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):                                 # in k order, in x's dtype
        y = y + contrib[:, j]
    return y


def _resolve(x: torch.Tensor, cfg: ModelConfig, strategy: Optional[str],
             capacity_factor: Optional[float], workload: Optional[str]) -> Tuple[str, float]:
    wl = workload or workload_signature(x.shape[0] * x.shape[1], cfg.moe_num_experts,
                                        cfg.moe_top_k)
    s = moe_settings.settings_for(wl)
    strategy = strategy or s["strategy"]
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown MoE strategy {strategy!r} (have {STRATEGIES})")
    return strategy, float(capacity_factor or s["capacity_factor"])


def apply_moe(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,                 # (B, S, d)
    cfg: ModelConfig,
    *,
    strategy: Optional[str] = None,
    capacity_factor: Optional[float] = None,
    workload: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, d) in x's dtype, aux_loss f32).  ``strategy`` and
    ``capacity_factor`` resolve through ``torch_moe_dispatch`` for the
    call's :func:`workload_signature` unless given."""
    strategy, cf = _resolve(x, cfg, strategy, capacity_factor, workload)
    if shd.sharded_mesh() is not None:
        return _moe_shard_map(params, x, cfg, cf, strategy)
    b, sl, d = x.shape
    t = b * sl
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    x2d = x.reshape(t, d)
    gates, ids, probs = _route(params, x2d, cfg)
    aux = router_aux_loss(probs, ids, e)

    if strategy == "dense":
        ye = _expert_ffn(params, x2d.expand(e, t, d))                   # (E, T, d)
        w = torch.einsum("tk,tke->te", gates, _onehot(ids, e, torch.float32))
        y = torch.einsum("te,etd->td", w.to(x.dtype), ye)
        return y.reshape(b, sl, d), aux
    # gather, local_tp and auto: one device's capacity dispatch
    y = _gather_dispatch(params, x2d, gates, ids, capacity(t, e, k, cf))
    return y.reshape(b, sl, d), aux


def _local_moe(params: Dict[str, torch.Tensor], x2d: torch.Tensor, cfg: ModelConfig, cf: float,
               strategy: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's tokens through its ff shard of every expert: (y, aux)."""
    t, d = x2d.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    gates, ids, probs = _route(params, x2d, cfg)
    aux = router_aux_loss(probs, ids, e)
    if strategy == "dense":
        ye = _expert_ffn(params, x2d.expand(e, t, d))
        w = torch.einsum("tk,tke->te", gates, _onehot(ids, e, torch.float32))
        return torch.einsum("te,etd->td", w.to(x2d.dtype), ye), aux
    return _gather_dispatch(params, x2d, gates, ids, capacity(t, e, k, cf)), aux


def _moe_shard_map(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                   cf: float, strategy: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer in a sharded program (module docstring)."""
    sizes = shd.mesh_sizes(shd.sharded_mesh())
    b, sl, _ = x.shape
    batch, n = (), 1
    for a in ("pod", "data"):          # the largest prefix of (pod, data) dividing the batch
        if a in sizes and b % (n * sizes[a]) == 0:
            batch, n = batch + (a,), n * sizes[a]
    ff = shd.tp_axes(batch, cfg.moe_d_ff)
    seq = "model" if "model" in sizes and "model" not in ff and sl % sizes["model"] == 0 \
        else None
    x_lay = shd.Layout((shd.entry(batch), seq, None))
    f = shd.entry(ff)
    w_in = {"router": shd.Layout((None, None)), "wi_gate": shd.Layout((None, None, f)),
            "wi_up": shd.Layout((None, None, f)), "wo": shd.Layout((None, f, None))}

    def body(p, xl):
        bl, s_l, d = xl.shape
        y, aux = _local_moe(p, xl.reshape(bl * s_l, d), cfg, cf, strategy)
        return y.reshape(bl, s_l, d), aux

    every = tuple(sizes)
    y, aux = shd.local_call(body, (shd.Layout(x_lay.dims, ff), shd.Layout((), every, "avg")),
                            (w_in, x_lay), {n: params[n] for n in w_in}, x)
    return shd.constrain(y, ("batch", "seq", None)), shd.constrain(aux, ())


def dropped_frac(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
                 capacity_factor: Optional[float] = None) -> torch.Tensor:
    """The ``dropped_frac`` metric: the share of (token, choice) assignments
    of ``x`` past their expert's capacity (0-d f32 tensor on x's device)."""
    _, cf = _resolve(x, cfg, "gather", capacity_factor, None)
    t = x.shape[0] * x.shape[1]
    _, ids, _ = _route(params, x.reshape(t, x.shape[-1]), cfg)
    cap = capacity(t, cfg.moe_num_experts, cfg.moe_top_k, cf)
    _, keep, _ = dispatch_plan(ids, cfg.moe_num_experts, cap)
    return 1.0 - keep.float().mean()
