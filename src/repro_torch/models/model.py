"""Top-level model, dense family: param specs, init, forward and serving.

The port of ``repro/models/model.py``.  Parameters are plain tensors in
nested dicts: ``embed``, ``ln_f``, ``out`` (unless tied) and ``blocks``, a
list with one dict per layer.  :func:`param_specs` keeps the reference's
stacked layout (a leading ``layers`` axis on every block leaf), so the spec
trees of the two packages compare leaf for leaf; :func:`init_params`
draws that layout and unstacks it.

Serving state is a list of per-layer caches ``{"k", "v"}`` of shape
(B, C, K, hd), updated in place by :func:`decode_step` and
:func:`merge_slot`.  ``loss_fn`` comes with training.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from .attention import attn_cache_spec
from .config import ModelConfig
from .layers import P, apply_norm, dtype_of, init_leaf, norm_params, torch_dtype
from .transformer import block_specs, decode_stack, forward_stack, prefill_stack, stack_specs

__all__ = [
    "param_specs", "init_params", "unstack_blocks", "forward", "logits_fn", "cache_specs",
    "init_cache", "cache_batch_axes", "merge_slot", "prefill", "decode_step",
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
    return params["embed"][tokens]


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


# ------------------------------------------------------------------- serving
def cache_specs(cfg: ModelConfig, batch: int, context: int) -> List[Dict[str, P]]:
    """Per-layer P-spec list of the decode state for ``context`` tokens."""
    if cfg.family != "dense":
        raise NotImplementedError(f"the port serves the dense family; {cfg.name} is {cfg.family}")
    return [attn_cache_spec(cfg, batch, context) for _ in range(cfg.n_layers)]


def init_cache(cfg: ModelConfig, batch: int, context: int, dtype: Optional[Any] = None,
               device: Union[str, torch.device] = "cuda") -> List[Dict[str, torch.Tensor]]:
    dtype = torch_dtype(dtype) if dtype is not None else dtype_of(cfg)
    return [_map(lambda p: torch.zeros(p.shape, dtype=p.with_dtype(dtype), device=device), layer)
            for layer in cache_specs(cfg, batch, context)]


def cache_batch_axes(cfg: ModelConfig, batch: int, context: int) -> List[Dict[str, int]]:
    """Per-leaf index of the batch axis, read off each leaf's logical names
    (the port holds caches per layer, so it is 0 for every dense leaf)."""
    return [_map(lambda p: p.logical.index("batch"), layer)
            for layer in cache_specs(cfg, batch, context)]


def merge_slot(big: List[Dict[str, torch.Tensor]], small: List[Dict[str, torch.Tensor]],
               slot: int, batch_axes: List[Dict[str, int]]) -> List[Dict[str, torch.Tensor]]:
    """Write a batch-1 decode state into row ``slot`` of a batched state, IN
    PLACE: every other slot's state is untouched, so live sequences keep
    decoding across the write.  ``slot`` is a Python int (no host sync)."""
    for b_layer, s_layer, ax_layer in zip(big, small, batch_axes):
        for name, ax in ax_layer.items():
            b_layer[name].select(ax, slot).copy_(s_layer[name].select(ax, 0))
    return big


def prefill(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            cache_capacity: int) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]], int]:
    """Process a prompt; returns (last-token logits (B, V), caches, pos = S)."""
    h, caches = prefill_stack(params["blocks"], _embed(params, tokens), cfg, cache_capacity)
    h = apply_norm(params["ln_f"], h[:, -1:], cfg)
    return logits_fn(params, cfg, h)[:, 0], caches, tokens.shape[1]


def decode_step(params: Dict[str, Any], cfg: ModelConfig, token: torch.Tensor,
                caches: List[Dict[str, torch.Tensor]], pos: Union[int, torch.Tensor],
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One decode step: consumes ``token`` (B,) at position ``pos`` (an int,
    or a (B,) tensor of per-slot positions) and returns (next-token logits
    (B, V), caches).  Rows are independent: each follows its own position."""
    h, caches = decode_stack(params["blocks"], _embed(params, token[:, None]), caches, pos, cfg)
    h = apply_norm(params["ln_f"], h, cfg)
    return logits_fn(params, cfg, h)[:, 0], caches
