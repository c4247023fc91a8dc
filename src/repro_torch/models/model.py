"""Top-level model: param specs, init, forward and serving (dense, ssm, hybrid).

The port of ``repro/models/model.py``.  Parameters are plain tensors in
nested dicts: ``embed``, ``ln_f``, ``out`` (unless tied) and ``blocks``, a
list with one dict per layer.  :func:`param_specs` keeps the reference's
stacked layout (a leading ``layers`` axis on every block leaf), so the spec
trees of the two packages compare leaf for leaf; :func:`init_params`
draws that layout and unstacks it.

Serving state is a list of per-layer cache dicts: ``{"k", "v"}`` of shape
(B, C, K, hd) for attention, ``{"ssm": {"conv", "ssd"}}`` for an SSM mixer,
all three for a hybrid layer.  :func:`decode_step` updates every leaf in
place (K/V rows and each SSM state), so a captured decode step can hold the
state; :func:`merge_slot` writes one slot in place, and :func:`install_slot`
writes slots named by a device tensor together with their ``(tok, pos,
done)``.

Training: :func:`loss_fn` is the next-token cross-entropy over sequence
chunks of ``torch_layer_stack.loss_chunk`` (:func:`_chunked_ce`), so the
(B, S, V) logits are never materialized when the sequence is longer than
a chunk; each chunk body is recomputed in the backward pass.  The
embedding lookup is ``F.embedding``, whose gradient on the card sorts the
token ids and sums each id's rows in a fixed order (no float atomics), so
a train step gives the same bits every time it runs on the same inputs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from .attention import attn_cache_spec
from .config import ModelConfig
from .layers import P, apply_norm, dtype_of, init_leaf, norm_params, torch_dtype
from .ssm import ssm_state_spec
from .transformer import (FAMILIES, block_specs, decode_stack, forward_stack, prefill_stack,
                          stack_settings, stack_specs, stack_workload)

__all__ = [
    "param_specs", "init_params", "unstack_blocks", "forward", "logits_fn", "loss_fn",
    "cache_specs", "init_cache", "cache_batch_axes", "merge_slot", "install_slot", "prefill",
    "decode_step",
]


# --------------------------------------------------------------------- specs
def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, vp = cfg.d_model, cfg.padded_vocab
    specs: Dict[str, Any] = {
        "embed": P((vp, d), ("vocab", "d_model"), "embed"),
        "ln_f": norm_params(cfg),
    }
    if not cfg.tie_embeddings:
        specs["out"] = P((d, vp), ("d_model", "vocab"))
    specs["blocks"] = stack_specs(block_specs(cfg), cfg.n_layers)
    return specs


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack_blocks(params: Dict[str, Any], n_layers: int) -> Dict[str, Any]:
    """Stacked ``blocks`` (leading layer axis on every leaf) → one dict per
    layer (views of the stacked tensors)."""
    out = dict(params)
    out["blocks"] = [_map(lambda t, i=i: t[i], params["blocks"]) for i in range(n_layers)]
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator, device: Union[str, torch.device] = "cuda",
                dtype: Optional[Any] = None) -> Dict[str, Any]:
    """Materialize parameters from ``generator`` (which must live on
    ``device``), in spec order."""
    dtype = torch_dtype(dtype) if dtype is not None else dtype_of(cfg)
    device = torch.device(device)
    stacked = _map(lambda p: init_leaf(generator, p, p.with_dtype(dtype), device), param_specs(cfg))
    return unstack_blocks(stacked, cfg.n_layers)


# ------------------------------------------------------------------- forward
def _embed(params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["embed"])


def forward(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) → final hidden states (B, S, d), normalized."""
    h = forward_stack(params["blocks"], _embed(params, tokens), cfg)
    return apply_norm(params["ln_f"], h, cfg)


def _out_weight(params: Dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    return params["out"] if not cfg.tie_embeddings else params["embed"].T


def logits_fn(params: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Full f32 logits; the padded vocab is masked to −1e30 (not −inf, so an
    argmax over a row never meets a tie with a masked entry)."""
    logits = (h @ _out_weight(params, cfg)).float()
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, -1e30)
    return logits


def _ce_chunk(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, vocab: int):
    """(sum of the valid positions' NLL, their count) over one chunk.  The
    label logit is a gather: on one device nothing is gained by the
    reference's iota compare, which exists for a vocab-sharded logits
    tensor (each row gathers one entry, so its gradient adds nothing twice)."""
    logits = (h @ w).float()
    if logits.shape[-1] != vocab:
        mask = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(mask, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    valid = (labels >= 0).float()
    return torch.sum((lse - ll) * valid), torch.sum(valid)


def _chunked_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Next-token CE over sequence chunks of ``loss_chunk`` (halved until it
    divides S).  With more than one chunk, each chunk's body is recomputed
    in the backward pass (the reference's ``jax.checkpoint`` over its scan)."""
    b, s, _ = h.shape
    chunk = min(stack_settings.settings_for(
        stack_workload(cfg.family, b, s, cfg.n_layers))["loss_chunk"], s)
    while s % chunk:
        chunk //= 2
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        args = (h[:, c0:c0 + chunk], w, labels[:, c0:c0 + chunk], cfg.vocab_size)
        if chunk == s or not torch.is_grad_enabled():
            part, n = _ce_chunk(*args)
        else:
            part, n = _ckpt.checkpoint(_ce_chunk, *args, use_reentrant=False)
        nll, cnt = nll + part, cnt + n
    return nll / torch.clamp(cnt, min=1.0)


def loss_fn(params: Dict[str, Any], cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S) and labels (B, S) integer tensors (label -1 =
    pad).  Returns (loss, {"ce", "aux"}); ``aux`` is the MoE balance loss,
    zero for the families the port runs."""
    h = forward(params, cfg, batch["tokens"])
    ce = _chunked_ce(h, _out_weight(params, cfg), batch["labels"], cfg)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device)}


# ------------------------------------------------------------------- serving
def _layer_cache_spec(cfg: ModelConfig, batch: int, context: int) -> Dict[str, Any]:
    layer: Dict[str, Any] = {}
    if cfg.family in ("dense", "hybrid"):
        layer.update(attn_cache_spec(cfg, batch, context))
    if cfg.family in ("ssm", "hybrid"):
        layer["ssm"] = ssm_state_spec(cfg, batch)
    return layer


def cache_specs(cfg: ModelConfig, batch: int, context: int) -> List[Dict[str, Any]]:
    """Per-layer P-spec list of the decode state for ``context`` tokens
    (a fresh dict for each layer)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"the port serves the {'/'.join(FAMILIES)} families; "
                                  f"{cfg.name} is {cfg.family}")
    return [_layer_cache_spec(cfg, batch, context) for _ in range(cfg.n_layers)]


def init_cache(cfg: ModelConfig, batch: int, context: int, dtype: Optional[Any] = None,
               device: Union[str, torch.device] = "cuda") -> List[Dict[str, Any]]:
    """Zero decode state; the SSD state stays float32 (its spec's pin)."""
    dtype = torch_dtype(dtype) if dtype is not None else dtype_of(cfg)
    return [_map(lambda p: torch.zeros(p.shape, dtype=p.with_dtype(dtype), device=device), layer)
            for layer in cache_specs(cfg, batch, context)]


def cache_batch_axes(cfg: ModelConfig, batch: int, context: int) -> List[Dict[str, Any]]:
    """Per-leaf index of the batch axis, read off each leaf's logical names
    (the port holds caches per layer, so it is 0 for every leaf so far)."""
    return [_map(lambda p: p.logical.index("batch"), layer)
            for layer in cache_specs(cfg, batch, context)]


def _merge(big: Any, small: Any, slot: int, axes: Any) -> None:
    if isinstance(axes, dict):
        for name, ax in axes.items():
            _merge(big[name], small[name], slot, ax)
    else:
        big.select(axes, slot).copy_(small.select(axes, 0))


def merge_slot(big: List[Dict[str, Any]], small: List[Dict[str, Any]], slot: int,
               batch_axes: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Write a batch-1 decode state into row ``slot`` of a batched state, IN
    PLACE (nested dicts included): every other slot's state is untouched, so
    live sequences keep decoding across the write.  ``slot`` is a Python int
    (no host sync)."""
    for b_layer, s_layer, ax_layer in zip(big, small, batch_axes):
        _merge(b_layer, s_layer, slot, ax_layer)
    return big


def _install(big: Any, small: Any, slots: torch.Tensor, axes: Any) -> None:
    if isinstance(axes, dict):
        for name, ax in axes.items():
            _install(big[name], small[name], slots, ax)
    else:
        big.index_copy_(axes, slots, small.to(big.dtype))


def install_slot(big: List[Dict[str, Any]], small: List[Dict[str, Any]], slots: torch.Tensor,
                 tok: torch.Tensor, pos: torch.Tensor, done: torch.Tensor, logits: torch.Tensor,
                 width: int, *, batch_axes: List[Dict[str, Any]]) -> None:
    """Admit prefilled rows, IN PLACE: row ``i`` of ``small`` goes to slot
    ``slots[i]`` of every cache leaf (``index_copy_`` along its batch axis),
    and the slot's registers become ``tok`` = the argmax of row ``i`` of
    the prefill ``logits``, ``pos`` = ``width``, ``done`` = False.  The port
    of the reference server's ``_install``; ``slots`` is a device tensor, so
    one captured program serves every slot.  Values equal :func:`merge_slot`
    plus the three register writes."""
    for b_layer, s_layer, ax_layer in zip(big, small, batch_axes):
        _install(b_layer, s_layer, slots, ax_layer)
    tok.index_copy_(0, slots, torch.argmax(logits, -1).to(tok.dtype))
    pos.index_fill_(0, slots, width)
    done.index_fill_(0, slots, False)


def prefill(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            cache_capacity: int) -> Tuple[torch.Tensor, List[Dict[str, Any]], int]:
    """Process a prompt; returns (last-token logits (B, V), caches, pos = S)."""
    h, caches = prefill_stack(params["blocks"], _embed(params, tokens), cfg, cache_capacity)
    h = apply_norm(params["ln_f"], h[:, -1:], cfg)
    return logits_fn(params, cfg, h)[:, 0], caches, tokens.shape[1]


def decode_step(params: Dict[str, Any], cfg: ModelConfig, token: torch.Tensor,
                caches: List[Dict[str, Any]], pos: Union[int, torch.Tensor],
                ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """One decode step: consumes ``token`` (B,) at position ``pos`` (an int,
    or a (B,) tensor of per-slot positions) and returns (next-token logits
    (B, V), caches).  Rows are independent: each follows its own position.
    ``caches`` is updated in place and returned."""
    h, caches = decode_stack(params["blocks"], _embed(params, token[:, None]), caches, pos, cfg)
    h = apply_norm(params["ln_f"], h, cfg)
    return logits_fn(params, cfg, h)[:, 0], caches
