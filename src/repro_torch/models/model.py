"""Top-level model: param specs, init, forward, loss and serving (all six families).

The port of ``repro/models/model.py``.  Parameters are plain tensors in
nested dicts: ``embed``, ``ln_f``, ``out`` (unless tied) and the stacks,
lists with one dict per layer: ``blocks`` (the decoder's for an
encoder-decoder), plus ``enc`` and ``enc_ln_f`` (the encoder) for
``encdec``; for ``vlm``, ``xblocks`` (one cross block per group) and
``blocks``, a list per group of its ``cross_attn_period`` dense layers.
:func:`param_specs` keeps the reference's stacked layout (a leading
``layers`` axis on every stack leaf, two for the VLM's ``blocks``), so the
spec trees of the two packages compare leaf for leaf; :func:`init_params`
draws that layout and :func:`unstack_blocks` unstacks it.

Serving state is a list with one cache dict per layer: ``{"k", "v"}`` of
shape (B, C, K, hd) for attention (a ring buffer of the window's length
where ``cfg.window``), ``{"ssm": {"conv", "ssd"}}`` for an SSM mixer, all
three for a hybrid layer, and for an encoder-decoder's decoder layer also
``{"xk", "xv"}``, the static cross cache of ``cfg.cache_len(enc_len)``
source positions.  A VLM's state has one dict per group, ``{"xk", "xv",
"inner": [per-layer {"k", "v"}]}``, its cross cache always
``num_modal_tokens`` long.  :func:`decode_step` updates every self-attention
and SSM leaf in place, so a captured decode step can hold the state, and
reads the cross caches without writing them; :func:`merge_slot` writes one
slot in place, and :func:`install_slot` writes slots named by a device
tensor together with their ``(tok, pos, done)``.

The modal input (``modal``, (B, S_src, d)) is the stubbed frontend's
output, as in the reference: an encoder-decoder encodes it (non-causal
self-attention) and its decoder cross-attends to the normed encoder
output; a VLM cross-attends to it directly.  It is cast to the
activations' dtype.  The reference's :func:`forward` runs its encdec
decoder stack with the family name as the block kind, which no block
matches, so its forward and loss skip the encoder and the decoder
(``h = ln_f(embed(tokens))``); the port runs them, as the reference's
:func:`prefill` and :func:`decode_step` do (ROADMAP, reference caveats).

Training: :func:`loss_fn` is the next-token cross-entropy over sequence
chunks of ``torch_layer_stack.loss_chunk`` (:func:`_chunked_ce`), so the
(B, S, V) logits are never materialized when the sequence is longer than
a chunk; each chunk body is recomputed in the backward pass; a MoE model
adds ``MOE_AUX_WEIGHT`` times the balance loss summed over its layers.  In a
sharded program the logits are vocab-parallel (the reference's layout): each
rank computes its vocabulary shard's logits, and the cross-entropy combines
the shards' log-sum-exps and the label logit found by comparing each
column's global index with the label (the reference's iota compare).  The
embedding lookup is ``F.embedding``, whose gradient on the card sorts the
token ids and sums each id's rows in a fixed order (no float atomics), so
a train step gives the same bits every time it runs on the same inputs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from ..parallel import sharding as shd
from ..tree import leaves
from .attention import attn_cache_spec
from .config import ModelConfig
from .layers import P, apply_norm, dtype_of, init_leaf, norm_params, torch_dtype
from .ssm import ssm_state_spec
from .transformer import (FAMILIES, block_specs, decode_stack, forward_stack, prefill_stack,
                          stack_settings, stack_specs, stack_workload)

__all__ = [
    "param_specs", "init_params", "unstack_blocks", "stack_args", "forward", "logits_fn",
    "loss_fn",
    "cache_specs", "init_cache", "cache_batch_axes", "merge_slot", "install_slot", "prefill",
    "decode_step", "MOE_AUX_WEIGHT",
]

MOE_AUX_WEIGHT = 0.01


# --------------------------------------------------------------------- specs
def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, vp = cfg.d_model, cfg.padded_vocab
    specs: Dict[str, Any] = {
        "embed": P((vp, d), ("vocab", "d_model"), "embed"),
        "ln_f": norm_params(cfg),
    }
    if not cfg.tie_embeddings:
        specs["out"] = P((d, vp), ("d_model", "vocab"))
    if cfg.family == "encdec":
        specs["enc"] = stack_specs(block_specs(cfg, "encoder"), cfg.enc_layers)
        specs["enc_ln_f"] = norm_params(cfg)
        specs["blocks"] = stack_specs(block_specs(cfg, "decoder"), cfg.n_layers)
    elif cfg.family == "vlm":
        groups = cfg.n_layers // cfg.cross_attn_period
        specs["xblocks"] = stack_specs(block_specs(cfg, "xblock"), groups)
        specs["blocks"] = stack_specs(stack_specs(block_specs(cfg, "dense"),
                                                  cfg.cross_attn_period), groups)
    else:
        specs["blocks"] = stack_specs(block_specs(cfg), cfg.n_layers)
    return specs


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _stacks(cfg: ModelConfig) -> Dict[str, int]:
    """The stacked entries of the parameter tree and their stacked axes."""
    if cfg.family == "encdec":
        return {"enc": 1, "blocks": 1}
    if cfg.family == "vlm":
        return {"xblocks": 1, "blocks": 2}
    return {"blocks": 1}


def _take(leaf: Any, i: int) -> Any:
    """Entry ``i`` of a stacked leaf: a view of a tensor, or a spec without
    its leading axis."""
    if isinstance(leaf, P):
        return P(leaf.shape[1:], leaf.logical[1:], leaf.init, leaf.scale, leaf.dtype)
    return leaf[i]


def _unstack(tree: Any, depth: int) -> Any:
    """The leading ``depth`` axes of every leaf of ``tree`` → nested lists
    of trees."""
    if depth == 0:
        return tree
    return [_unstack(_map(lambda t, i=i: _take(t, i), tree), depth - 1)
            for i in range(leaves(tree)[0].shape[0])]


def unstack_blocks(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The stacked layout (leading layer axes on every stack leaf) → the
    port's (views of the stacked tensors; on a spec tree, the specs of the
    port's leaves): ``blocks`` (and ``enc``) a list of layers, ``xblocks``
    a list of groups, a VLM's ``blocks`` a list of groups, each a list of
    layers."""
    out = dict(params)
    for name, depth in _stacks(cfg).items():
        out[name] = _unstack(params[name], depth)
    return out


def stack_args(params: Dict[str, Any], cfg: ModelConfig) -> List[Any]:
    """The units the stack functions of :mod:`.transformer` loop over: the
    layers of ``blocks``, or for the VLM one ``{"xb", "blocks"}`` per group."""
    if cfg.family == "vlm":
        return [{"xb": xb, "blocks": blocks}
                for xb, blocks in zip(params["xblocks"], params["blocks"])]
    return params["blocks"]


def _decoder_kind(cfg: ModelConfig) -> str:
    return "decoder" if cfg.family == "encdec" else cfg.family


def _source(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
            modal: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The cross-attention source: the normed encoder output of ``modal``
    (encdec), ``modal`` itself (vlm), None for the other families."""
    if cfg.family not in ("encdec", "vlm"):
        return None
    if modal is None:
        raise ValueError(f"{cfg.name} ({cfg.family}) needs the modal input")
    modal = modal.to(x.dtype)
    if cfg.family == "vlm":
        return modal
    enc_h, _ = forward_stack(params["enc"], modal, cfg, kind="encoder")
    return apply_norm(params["enc_ln_f"], enc_h, cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator, device: Union[str, torch.device] = "cuda",
                dtype: Optional[Any] = None) -> Dict[str, Any]:
    """Materialize parameters from ``generator`` (which must live on
    ``device``), in spec order."""
    dtype = torch_dtype(dtype) if dtype is not None else dtype_of(cfg)
    device = torch.device(device)
    stacked = _map(lambda p: init_leaf(generator, p, p.with_dtype(dtype), device), param_specs(cfg))
    return unstack_blocks(stacked, cfg)


# ------------------------------------------------------------------- forward
def _embed(params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    if shd.sharded_mesh() is not None:
        return _embed_sharded(params["embed"], tokens)
    return shd.constrain(F.embedding(tokens, params["embed"]), ("batch", "seq", None))


def _embed_sharded(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel lookup: each rank reads the rows of its vocabulary
    shard (zeros for the others' tokens), a partial sum over ``model``
    reduced into the residual's layout."""
    bd = shd.layout_of(tokens).dims[0]
    v_ax = shd.layout_of(table).dims[0]

    def body(tl, tok):
        first = shd.axis_rank("model") * tl.shape[0] if v_ax else 0
        rel = tok - first
        here = (rel >= 0) & (rel < tl.shape[0])
        return F.embedding(rel.clamp(0, tl.shape[0] - 1), tl) * here[..., None].to(tl.dtype)

    x = shd.local_call(body, shd.Layout((bd, None, None), (v_ax,) if v_ax else ()),
                       (shd.Layout((v_ax, None)), shd.Layout((bd, None))), table, tokens)
    return shd.constrain(x, ("batch", "seq", None))


def forward(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            modal: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) [, modal (B, S_src, d) for encdec and vlm] → (final
    hidden states (B, S, d), normalized; the MoE aux loss summed over the
    layers, a 0-d f32 tensor: 0 but for MoE)."""
    x = _embed(params, tokens)
    src = _source(params, cfg, x, modal)
    h, aux = forward_stack(stack_args(params, cfg), x, cfg, kind=_decoder_kind(cfg), src=src)
    return apply_norm(params["ln_f"], h, cfg), aux


def _out_weight(params: Dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    return params["out"] if not cfg.tie_embeddings else params["embed"].T


def _vocab_logits(h: torch.Tensor, w: torch.Tensor, vocab: int) -> torch.Tensor:
    """f32 logits of each rank's vocabulary shard (the padded columns masked
    to −1e30), a DTensor sharded over ``model`` on its last dimension."""
    bd = shd.layout_of(h).dims[0]
    v_ax = shd.layout_of(w).dims[1]

    def body(hl, wl):
        logits = (hl @ wl).float()
        first = shd.axis_rank("model") * wl.shape[1] if v_ax else 0
        cols = first + torch.arange(wl.shape[1], device=hl.device)
        return torch.where(cols < vocab, logits, -1e30)

    lay = shd.Layout((bd, None, v_ax))
    return shd.local_call(body, lay, (shd.Layout((bd, None, None)), shd.Layout((None, v_ax))),
                          h, w)


def logits_fn(params: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Full f32 logits; the padded vocab is masked to −1e30 (not −inf, so an
    argmax over a row never meets a tie with a masked entry)."""
    if shd.sharded_mesh() is not None:
        return _vocab_logits(h, _out_weight(params, cfg), cfg.vocab_size)
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


def _ce_chunk_sharded(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, vocab: int):
    """:func:`_ce_chunk` on vocab-parallel logits: each shard's log-sum-exp,
    gathered and combined, and the label logit as a sum over the shards of
    the column whose global index is the label."""
    logits = _vocab_logits(h, w, vocab)
    bd, v_ax = shd.layout_of(logits).dims[0], shd.layout_of(logits).dims[2]
    labels = shd.constrain(labels, ("batch", None))

    def body(lg, lb):
        first = shd.axis_rank("model") * lg.shape[-1] if v_ax else 0
        cols = first + torch.arange(lg.shape[-1], device=lg.device)
        ll = torch.sum(torch.where(cols == lb.clamp(min=0)[..., None], lg, 0.0), dim=-1)
        return torch.logsumexp(lg, dim=-1, keepdim=True), ll

    parts, ll = shd.local_call(body, (shd.Layout((bd, None, v_ax)),
                                      shd.Layout((bd, None), (v_ax,) if v_ax else ())),
                               (shd.Layout((bd, None, v_ax)), shd.Layout((bd, None))),
                               logits, labels)
    lse = torch.logsumexp(shd.constrain(parts, ("batch", None, None)), dim=-1)
    ll = shd.constrain(ll, ("batch", None))
    valid = (labels >= 0).float()
    # each sum whole on every rank: the chunks' ratio is of the sums, never a
    # sum of the shards' ratios
    return (shd.constrain(torch.sum((lse - ll) * valid), ()),
            shd.constrain(torch.sum(valid), ()))


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
    ce_chunk = _ce_chunk
    if shd.sharded_mesh() is not None:      # the sequence gathered once, not per chunk
        h, labels = shd.constrain(h, ("batch", None, None)), shd.constrain(labels, ("batch", None))
        ce_chunk = _ce_chunk_sharded
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        args = (h[:, c0:c0 + chunk], w, labels[:, c0:c0 + chunk], cfg.vocab_size)
        if chunk == s or not torch.is_grad_enabled():
            part, n = ce_chunk(*args)
        else:
            part, n = _ckpt.checkpoint(shd.carry_rules(ce_chunk), *args, use_reentrant=False)
        nll, cnt = nll + part, cnt + n
    return nll / torch.clamp(cnt, min=1.0)


def loss_fn(params: Dict[str, Any], cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S) and labels (B, S) integer tensors (label -1 =
    pad), and ``modal`` (B, S_src, d) for encdec and vlm.  Returns (loss, {"ce", "aux"}): loss = ce + ``MOE_AUX_WEIGHT``·aux
    for a MoE model, ce otherwise; ``aux`` is the MoE balance loss summed
    over the layers (zero for the other families)."""
    h, aux = forward(params, cfg, batch["tokens"], batch.get("modal"))
    ce = _chunked_ce(h, _out_weight(params, cfg), batch["labels"], cfg)
    loss = ce + MOE_AUX_WEIGHT * aux if cfg.is_moe else ce
    return loss, {"ce": ce, "aux": aux}


# ------------------------------------------------------------------- serving
def _layer_cache_spec(cfg: ModelConfig, kind: str, batch: int, context: int,
                      enc_len: Optional[int]) -> Dict[str, Any]:
    layer: Dict[str, Any] = {}
    if kind in ("dense", "moe", "hybrid", "decoder"):
        layer.update(attn_cache_spec(cfg, batch, context))
    if kind in ("ssm", "hybrid"):
        layer["ssm"] = ssm_state_spec(cfg, batch)
    if kind == "decoder":
        x = attn_cache_spec(cfg, batch, enc_len or context)
        layer["xk"], layer["xv"] = x["k"], x["v"]
    return layer


def cache_specs(cfg: ModelConfig, batch: int, context: int,
                enc_len: Optional[int] = None) -> List[Dict[str, Any]]:
    """P-spec list of the decode state for ``context`` tokens (a fresh dict
    for each layer): one dict per layer, or per VLM group.  ``enc_len`` is
    the encoder-decoder's source length (default ``context``); the VLM's
    cross cache always holds ``num_modal_tokens``, whatever the context."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"the port serves the {'/'.join(FAMILIES)} families; "
                                  f"{cfg.name} is {cfg.family}")
    if cfg.family == "vlm":
        def group() -> Dict[str, Any]:
            x = attn_cache_spec(cfg, batch, cfg.num_modal_tokens)
            return {"xk": x["k"], "xv": x["v"],
                    "inner": [_layer_cache_spec(cfg, "dense", batch, context, None)
                              for _ in range(cfg.cross_attn_period)]}
        return [group() for _ in range(cfg.n_layers // cfg.cross_attn_period)]
    kind = _decoder_kind(cfg)
    return [_layer_cache_spec(cfg, kind, batch, context, enc_len) for _ in range(cfg.n_layers)]


def init_cache(cfg: ModelConfig, batch: int, context: int, enc_len: Optional[int] = None,
               dtype: Optional[Any] = None,
               device: Union[str, torch.device] = "cuda") -> List[Dict[str, Any]]:
    """Zero decode state; the SSD state stays float32 (its spec's pin)."""
    dtype = torch_dtype(dtype) if dtype is not None else dtype_of(cfg)
    return _map(lambda p: torch.zeros(p.shape, dtype=p.with_dtype(dtype), device=device),
                cache_specs(cfg, batch, context, enc_len))


def cache_batch_axes(cfg: ModelConfig, batch: int, context: int,
                     enc_len: Optional[int] = None) -> List[Dict[str, Any]]:
    """Per-leaf index of the batch axis, read off each leaf's logical names
    (the port holds caches per layer, so it is 0 for every leaf so far)."""
    return _map(lambda p: p.logical.index("batch"), cache_specs(cfg, batch, context, enc_len))


def _merge(big: Any, small: Any, slot: int, axes: Any) -> None:
    if isinstance(axes, dict):
        for name, ax in axes.items():
            _merge(big[name], small[name], slot, ax)
    elif isinstance(axes, list):
        for b, s, ax in zip(big, small, axes):
            _merge(b, s, slot, ax)
    else:
        big.select(axes, slot).copy_(small.select(axes, 0))


def merge_slot(big: List[Dict[str, Any]], small: List[Dict[str, Any]], slot: int,
               batch_axes: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Write a batch-1 decode state into row ``slot`` of a batched state, IN
    PLACE (nested dicts and lists included: a VLM group's inner layers):
    every other slot's state is untouched, so live sequences keep decoding
    across the write.  ``slot`` is a Python int (no host sync)."""
    _merge(big, small, slot, batch_axes)
    return big


def _install(big: Any, small: Any, slots: torch.Tensor, axes: Any) -> None:
    if isinstance(axes, dict):
        for name, ax in axes.items():
            _install(big[name], small[name], slots, ax)
    elif isinstance(axes, list):
        for b, s, ax in zip(big, small, axes):
            _install(b, s, slots, ax)
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
    _install(big, small, slots, batch_axes)
    tok.index_copy_(0, slots, torch.argmax(logits, -1).to(tok.dtype))
    pos.index_fill_(0, slots, width)
    done.index_fill_(0, slots, False)


def prefill(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            cache_capacity: int, modal: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[Dict[str, Any]], int]:
    """Process a prompt (and, for encdec and vlm, its modal input); returns
    (last-token logits (B, V), caches, pos = S)."""
    x = _embed(params, tokens)
    src = _source(params, cfg, x, modal)
    h, caches = prefill_stack(stack_args(params, cfg), x, cfg, cache_capacity,
                              kind=_decoder_kind(cfg), src=src)
    h = apply_norm(params["ln_f"], h[:, -1:], cfg)
    return logits_fn(params, cfg, h)[:, 0], caches, tokens.shape[1]


def decode_step(params: Dict[str, Any], cfg: ModelConfig, token: torch.Tensor,
                caches: List[Dict[str, Any]], pos: Union[int, torch.Tensor],
                ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """One decode step: consumes ``token`` (B,) at position ``pos`` (an int,
    or a (B,) tensor of per-slot positions) and returns (next-token logits
    (B, V), caches).  Each row follows its own position.  Rows are
    independent for every family except MoE, where expert capacity couples
    tokens across the batch (as in the reference).  ``caches`` is updated
    in place and returned."""
    h, caches = decode_stack(stack_args(params, cfg), _embed(params, token[:, None]), caches,
                             pos, cfg, kind=_decoder_kind(cfg))
    h = apply_norm(params["ln_f"], h, cfg)
    return logits_fn(params, cfg, h)[:, 0], caches
