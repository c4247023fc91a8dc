"""Transformer stacks for the six families.

The port of ``repro/models/transformer.py``:

  dense   norm→attn→res, norm→mlp→res
  moe     norm→attn→res, norm→moe→res (+aux loss summed over the layers)
  ssm     norm→mamba2→res
  hybrid  norm→(attn ∥ ssm: averaged)→res, norm→mlp→res   (Hymba)
  encdec  encoder stack (``encoder`` blocks: dense with NON-causal
          self-attention) + decoder stack (``decoder`` blocks: causal
          self-attention, cross-attention over the normed encoder output,
          mlp)
  vlm     groups: one ``xblock`` (norm→cross-attention over the modal
          source→res), then ``cross_attn_period`` dense blocks

The reference scans stacked parameters so its HLO stays O(1) in depth;
PyTorch runs eagerly, so the port holds one parameter dict per layer (for
the VLM, one dict per group: ``{"xb": cross block, "blocks": [period
dense layers]}``, built by :func:`repro_torch.models.model.stack_args`)
and loops over them.

``stack_settings`` is the ``torch_layer_stack`` component, resolved per
:func:`stack_workload` as in the reference.  ``remat`` is the activation
checkpoint applied to each layer of :func:`forward_stack` under autograd
(``torch.utils.checkpoint``, non-reentrant):

  * ``none`` — no checkpoint: every layer's activations are kept;
  * ``full`` — keep each layer's input only, recompute the layer in the
    backward pass (the reference's ``jax.checkpoint``);
  * ``dots`` — a selective checkpoint that keeps the outputs of the
    matrix products (``aten.mm``, ``bmm``, ``addmm``: the MoE's expert
    products are ``bmm``) and recomputes the rest (``jax.checkpoint_policies.checkpoint_dots``).

The checkpointed unit is the reference's: a layer, or a VLM group (the
reference also checkpoints each dense layer inside a group; one level is
kept here, the same numbers at one recompute less).
Under ``full`` and ``dots`` the recompute runs the layer's Python again,
so each attention or SSD kernel launches twice per layer and step (once
forward, once recomputed); under ``none`` once.  ``loss_chunk`` is read
by the model's chunked cross-entropy.  ``scan_layers`` has no torch
meaning and is kept for the tunable space.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils import checkpoint as _ckpt

from ..core.configstore import bucket_pow2
from ..core.registry import MetricSpec, tunable_component
from ..core.tunable import Categorical, Int
from ..parallel.sharding import carry_rules, constrain, is_dtensor
from .attention import apply_attn, apply_attn_decode, attn_params, cross_attn_params
from .config import ModelConfig
from .layers import P, apply_mlp, apply_norm, mlp_params, norm_params
from .moe import apply_moe, moe_params
from .ssm import apply_ssm, apply_ssm_decode, ssm_params

__all__ = ["FAMILIES", "stack_settings", "stack_workload", "block_specs", "stack_specs",
           "remat_wrap", "forward_stack", "prefill_stack", "decode_stack"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")   # the model families the port runs


@tunable_component(
    name="torch_layer_stack",
    tunables=(
        Categorical("remat", default="full", choices=("none", "dots", "full"),
                    description="activation-checkpoint policy per layer (autograd only)"),
        Categorical("scan_layers", default=True, choices=(True, False),
                    description="no meaning in the eager port; kept for the tunable space"),
        Int("loss_chunk", default=2048, low=128, high=16384, log=True,
            description="sequence chunk for the cross-entropy head"),
    ),
    metrics=(MetricSpec("time_us", "d"),),
)
class StackSettings:
    pass


stack_settings = StackSettings()


def stack_workload(kind: str, b: int, s: int, n_layers: int) -> str:
    """Bucketed stack-call signature: family × batch × seq × depth.  A train
    pass at (b=8, s=2048) and a prefill at (b=1, s=64) resolve their own
    remat and loss-chunk choices."""
    return f"{kind}_b{bucket_pow2(b)}s{bucket_pow2(s)}l{n_layers}"


# --------------------------------------------------------------------- specs
def block_specs(cfg: ModelConfig, kind: str = "auto") -> Dict[str, Any]:
    """P-spec tree for ONE layer of the given block kind (``auto``: the
    config's family)."""
    kind = cfg.family if kind == "auto" else kind
    if kind in ("dense", "encoder"):
        return {"ln1": norm_params(cfg), "attn": attn_params(cfg),
                "ln2": norm_params(cfg), "mlp": mlp_params(cfg)}
    if kind == "moe":
        return {"ln1": norm_params(cfg), "attn": attn_params(cfg),
                "ln2": norm_params(cfg), "moe": moe_params(cfg)}
    if kind == "ssm":
        return {"ln1": norm_params(cfg), "ssm": ssm_params(cfg)}
    if kind == "hybrid":
        return {"ln1": norm_params(cfg), "attn": attn_params(cfg), "ssm": ssm_params(cfg),
                "ln2": norm_params(cfg), "mlp": mlp_params(cfg)}
    if kind == "decoder":  # enc-dec decoder layer
        return {"ln1": norm_params(cfg), "attn": attn_params(cfg),
                "lnx": norm_params(cfg), "xattn": cross_attn_params(cfg),
                "ln2": norm_params(cfg), "mlp": mlp_params(cfg)}
    if kind == "xblock":   # vlm cross-attention block
        return {"lnx": norm_params(cfg), "xattn": cross_attn_params(cfg)}
    raise ValueError(f"no block kind {kind!r} ({cfg.name} is {cfg.family})")


def stack_specs(specs: Any, n: int) -> Any:
    """Add a leading ("layers",) axis to every leaf — the reference's stacked
    layout, which :func:`repro_torch.models.model.init_params` unstacks.  A
    leaf's dtype pin is kept (the reference's copy drops it)."""
    if isinstance(specs, P):
        return P((n, *specs.shape), ("layers", *specs.logical), specs.init, specs.scale,
                 specs.dtype)
    return {k: stack_specs(v, n) for k, v in specs.items()}


# ------------------------------------------------------------------- blocks
def _pad_kv(k: torch.Tensor, cfg: ModelConfig, cap: int) -> torch.Tensor:
    """Keep the last ``cap`` positions of a prefill's K or V; right-pad if
    the sequence is shorter."""
    sl = k.shape[1]
    if sl >= cap:
        # ring-buffer layout for windowed caches: token t lives at slot t % cap
        k, n = k[:, -cap:], sl % cap
        if cfg.window and not is_dtensor(k):
            k = torch.roll(k, n, dims=1)
        elif cfg.window and n:      # a sharded program: DTensor has no roll
            k = torch.cat([k[:, -n:], k[:, :-n]], dim=1)
    else:
        pad = torch.zeros((k.shape[0], cap - sl, *k.shape[2:]), dtype=k.dtype,
                          device=k.device)
        k = torch.cat([k, pad], dim=1)  # slots [0, sl) filled; pos continues at sl
    # the cache's layout (sequence-sharded over `model` in a sharded program)
    return constrain(k, ("batch", "cache_seq", "kv_heads", "head_dim"))


def _res(x: torch.Tensor) -> torch.Tensor:
    """Residual-stream layout pin (batch, seq, d_model)."""
    return constrain(x, ("batch", "seq", "d_model"))


def _cross(lp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, src: torch.Tensor,
           state: Dict[str, Any], keep_state: bool) -> torch.Tensor:
    """x + cross-attention of norm(x) over ``src``; the projected source
    goes to ``state["xk"]``, ``state["xv"]`` (the static cross cache)."""
    h, (xk, xv) = apply_attn(lp["xattn"], apply_norm(lp["lnx"], x, cfg), cfg, xkv=src)
    if keep_state:
        cache = ("batch", "cache_seq", "kv_heads", "head_dim")
        state["xk"], state["xv"] = constrain(xk, cache), constrain(xv, cache)
    return _res(x + h)


def _block(lp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, kind: str,
           src: Optional[torch.Tensor] = None, keep_state: bool = True
           ) -> Tuple[torch.Tensor, Dict[str, Any], Optional[torch.Tensor]]:
    """One full-sequence block of ``kind``.  Returns (x, the layer's decode
    state, the MoE aux loss or None): K/V of every position for attention,
    the cross cache of a decoder layer, the conv history and SSD state for
    an SSM mixer; an empty state without ``keep_state``."""
    state: Dict[str, Any] = {}
    xn = apply_norm(lp["ln1"], x, cfg)
    if kind == "ssm":
        y, ssm_state = apply_ssm(lp["ssm"], xn, cfg, return_state=keep_state)
        if keep_state:
            state["ssm"] = ssm_state
        return _res(x + y), state, None
    h, kv = apply_attn(lp["attn"], xn, cfg, causal=kind != "encoder")
    if keep_state:
        state["k"], state["v"] = kv
    if kind == "hybrid":
        s, ssm_state = apply_ssm(lp["ssm"], xn, cfg, return_state=keep_state)
        if keep_state:
            state["ssm"] = ssm_state
        h = (h + s) / 2.0
    x = _res(x + h)
    if kind == "decoder":
        x = _cross(lp, x, cfg, src, state, keep_state)
    if kind == "moe":
        y, aux = apply_moe(lp["moe"], apply_norm(lp["ln2"], x, cfg), cfg)
        return _res(x + y), state, aux
    return _res(x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)), state, None


def _group(gp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, src: torch.Tensor,
           keep_state: bool = True) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One VLM group: the cross block over the modal source, then its
    dense layers.  State: ``{"xk", "xv", "inner": [per-layer K/V]}``."""
    state: Dict[str, Any] = {}
    x = _cross(gp["xb"], x, cfg, src, state, keep_state)
    inner = []
    for lp in gp["blocks"]:
        x, layer_state, _ = _block(lp, x, cfg, "dense", keep_state=keep_state)
        inner.append(layer_state)
    if keep_state:
        state["inner"] = inner
    return x, state


def _layer(lp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, kind: str,
           src: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One unit of the train/forward pass (a layer, or a VLM group): (x,
    MoE aux or None); no decode state is kept."""
    if kind == "vlm":
        return _group(lp, x, cfg, src, keep_state=False)[0], None
    x, _, aux = _block(lp, x, cfg, kind, src, keep_state=False)
    return x, aux


def _save_dots(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> Any:
    from torch.utils.checkpoint import CheckpointPolicy

    dots = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)
    return CheckpointPolicy.MUST_SAVE if op in dots else CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn: Callable, policy: str) -> Callable:
    """``fn`` under the activation-checkpoint ``policy`` (module docstring)."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        context = functools.partial(_ckpt.create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False, context_fn=context)
    raise ValueError(f"unknown remat policy {policy!r}")


def forward_stack(layers: List[Any], x: torch.Tensor, cfg: ModelConfig, *,
                  kind: Optional[str] = None, src: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass over a stack of ``kind`` (default: the config's
    family; ``encoder`` and ``decoder`` for the two stacks of an
    encoder-decoder; ``vlm``: ``layers`` are groups).  ``src`` is the
    cross-attention source.  Returns (x, the MoE aux loss summed over the
    layers: 0 for the other families).  Under autograd each unit (a layer,
    a VLM group) runs under the resolved ``remat`` policy; without it, as
    it is."""
    kind = kind or cfg.family
    layer = _layer
    if torch.is_grad_enabled():
        s = stack_settings.settings_for(stack_workload(kind, x.shape[0], x.shape[1],
                                                       cfg.n_layers))
        layer = remat_wrap(carry_rules(_layer), s["remat"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layers:
        x, a = layer(lp, x, cfg, kind, src)
        if a is not None:
            aux = aux + a
    return x, aux


def prefill_stack(layers: List[Any], x: torch.Tensor, cfg: ModelConfig, cache_capacity: int,
                  *, kind: Optional[str] = None, src: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """Full-sequence pass that also fills each unit's decode state:
    attention layers keep K/V of the last ``cache_capacity`` positions, SSM
    layers their (conv, ssd) state, cross-attention the projected source
    (``xk``, ``xv``; every source position).  Returns (x, per-unit caches:
    one dict per layer, one ``{"xk", "xv", "inner"}`` per VLM group)."""
    kind = kind or cfg.family
    cap = cfg.cache_len(cache_capacity)

    def pad(cache: Dict[str, Any]) -> Dict[str, Any]:
        if "k" in cache:
            cache["k"], cache["v"] = _pad_kv(cache["k"], cfg, cap), _pad_kv(cache["v"], cfg, cap)
        return cache

    caches = []
    for lp in layers:
        if kind == "vlm":
            x, cache = _group(lp, x, cfg, src)
            cache["inner"] = [pad(c) for c in cache["inner"]]
        else:
            x, cache, _ = _block(lp, x, cfg, kind, src)
            pad(cache)
        caches.append(cache)
    return x, caches


def _decode_block(lp: Dict[str, Any], x: torch.Tensor, cache: Dict[str, Any],
                  pos: Union[int, torch.Tensor], cfg: ModelConfig, kind: str) -> torch.Tensor:
    xn = apply_norm(lp["ln1"], x, cfg)
    if kind == "ssm":
        y, _ = apply_ssm_decode(lp["ssm"], xn, cache["ssm"], cfg)
        return _res(x + y)
    h, _ = apply_attn_decode(lp["attn"], xn, cache, pos, cfg)
    if kind == "hybrid":
        s, _ = apply_ssm_decode(lp["ssm"], xn, cache["ssm"], cfg)
        h = (h + s) / 2.0
    x = _res(x + h)
    if kind == "decoder":
        x = _res(x + _cross_decode(lp, x, cache, pos, cfg))
    if kind == "moe":
        y, _ = apply_moe(lp["moe"], apply_norm(lp["ln2"], x, cfg), cfg)
        return _res(x + y)
    return _res(x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg))


def _cross_decode(lp: Dict[str, Any], x: torch.Tensor, cache: Dict[str, Any],
                  pos: Union[int, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    h, _ = apply_attn_decode(lp["xattn"], apply_norm(lp["lnx"], x, cfg),
                             {"k": cache["xk"], "v": cache["xv"]}, pos, cfg, cross=True)
    return h


def decode_stack(layers: List[Any], x: torch.Tensor, caches: List[Dict[str, Any]],
                 pos: Union[int, torch.Tensor], cfg: ModelConfig, *,
                 kind: Optional[str] = None) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """One-token pass over the stack (``kind`` as :func:`prefill_stack`).
    Every self-attention and SSM cache leaf is updated in place (see
    :func:`apply_attn_decode` and :func:`apply_ssm_decode`); the cross
    caches are read, never written."""
    kind = kind or cfg.family
    for lp, cache in zip(layers, caches):
        if kind == "vlm":
            x = _res(x + _cross_decode(lp["xb"], x, cache, pos, cfg))
            for inner_lp, inner_cache in zip(lp["blocks"], cache["inner"]):
                x = _decode_block(inner_lp, x, inner_cache, pos, cfg, "dense")
        else:
            x = _decode_block(lp, x, cache, pos, cfg, kind)
    return x, caches
