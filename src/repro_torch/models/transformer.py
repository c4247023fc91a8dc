"""Transformer stacks: dense, SSM (Mamba-2) and hybrid (Hymba) blocks.

The port of ``repro/models/transformer.py`` for three families:

  dense   norm→attn→res, norm→mlp→res
  ssm     norm→mamba2→res
  hybrid  norm→(attn ∥ ssm: averaged)→res, norm→mlp→res   (Hymba)

The reference scans stacked parameters so its HLO stays O(1) in depth;
PyTorch runs eagerly, so the port holds one parameter dict per layer and
loops over them.  The other block kinds (MoE, encoder-decoder, VLM) come
with their families.

``stack_settings`` is the ``torch_layer_stack`` component, resolved per
:func:`stack_workload` as in the reference.  ``remat`` is the activation
checkpoint applied to each layer of :func:`forward_stack` under autograd
(``torch.utils.checkpoint``, non-reentrant):

  * ``none`` — no checkpoint: every layer's activations are kept;
  * ``full`` — keep each layer's input only, recompute the layer in the
    backward pass (the reference's ``jax.checkpoint``);
  * ``dots`` — a selective checkpoint that keeps the outputs of the
    matrix products (``aten.mm``, ``bmm``, ``addmm``) and recomputes the
    rest (``jax.checkpoint_policies.checkpoint_dots``).

Under ``full`` and ``dots`` the recompute runs the layer's Python again,
so each attention or SSD kernel launches twice per layer and step (once
forward, once recomputed); under ``none`` once.  ``loss_chunk`` is read
by the model's chunked cross-entropy.  ``scan_layers`` has no torch
meaning and is kept for the tunable space.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Tuple, Union

import torch
from torch.utils import checkpoint as _ckpt

from ..core.configstore import bucket_pow2
from ..core.registry import MetricSpec, tunable_component
from ..core.tunable import Categorical, Int
from .attention import apply_attn, apply_attn_decode, attn_params
from .config import ModelConfig
from .layers import P, apply_mlp, apply_norm, mlp_params, norm_params
from .ssm import apply_ssm, apply_ssm_decode, ssm_params

__all__ = ["FAMILIES", "stack_settings", "stack_workload", "block_specs", "stack_specs",
           "remat_wrap", "forward_stack", "prefill_stack", "decode_stack"]

FAMILIES = ("dense", "ssm", "hybrid")   # the model families the port runs


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
def block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """P-spec tree for ONE layer of the config's family."""
    kind = cfg.family
    if kind == "dense":
        return {"ln1": norm_params(cfg), "attn": attn_params(cfg),
                "ln2": norm_params(cfg), "mlp": mlp_params(cfg)}
    if kind == "ssm":
        return {"ln1": norm_params(cfg), "ssm": ssm_params(cfg)}
    if kind == "hybrid":
        return {"ln1": norm_params(cfg), "attn": attn_params(cfg), "ssm": ssm_params(cfg),
                "ln2": norm_params(cfg), "mlp": mlp_params(cfg)}
    raise NotImplementedError(f"the port runs the {'/'.join(FAMILIES)} families; "
                              f"{cfg.name} is {kind}")


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
        return k[:, -cap:] if not cfg.window else torch.roll(k[:, -cap:], sl % cap, dims=1)
    pad = torch.zeros((k.shape[0], cap - sl, *k.shape[2:]), dtype=k.dtype, device=k.device)
    return torch.cat([k, pad], dim=1)  # slots [0, sl) filled; pos continues at sl


def _block(lp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
           keep_state: bool = True) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One full-sequence block.  Returns (x, the layer's decode state): K/V
    of every position for attention, the conv history and SSD state for an
    SSM mixer; an empty state without ``keep_state``."""
    state: Dict[str, Any] = {}
    xn = apply_norm(lp["ln1"], x, cfg)
    if cfg.family == "ssm":
        y, ssm_state = apply_ssm(lp["ssm"], xn, cfg, return_state=keep_state)
        if keep_state:
            state["ssm"] = ssm_state
        return x + y, state
    h, kv = apply_attn(lp["attn"], xn, cfg, causal=True)
    if keep_state:
        state["k"], state["v"] = kv
    if cfg.family == "hybrid":
        s, ssm_state = apply_ssm(lp["ssm"], xn, cfg, return_state=keep_state)
        if keep_state:
            state["ssm"] = ssm_state
        h = (h + s) / 2.0
    x = x + h
    return x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg), state


def _layer(lp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One block of the train/forward pass: no decode state is kept."""
    return _block(lp, x, cfg, keep_state=False)[0]


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


def forward_stack(layers: List[Dict[str, Any]], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence pass over the layer stack.  Under autograd each layer
    runs under the resolved ``remat`` policy; without it, as it is."""
    layer = _layer
    if torch.is_grad_enabled():
        s = stack_settings.settings_for(stack_workload(cfg.family, x.shape[0], x.shape[1],
                                                       cfg.n_layers))
        layer = remat_wrap(_layer, s["remat"])
    for lp in layers:
        x = layer(lp, x, cfg)
    return x


def prefill_stack(layers: List[Dict[str, Any]], x: torch.Tensor, cfg: ModelConfig,
                  cache_capacity: int) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """Full-sequence pass that also fills each layer's decode state:
    attention layers keep K/V of the last ``cache_capacity`` positions, SSM
    layers their (conv, ssd) state.  Returns (x, per-layer caches)."""
    cap = cfg.cache_len(cache_capacity)
    caches = []
    for lp in layers:
        x, cache = _block(lp, x, cfg)
        if "k" in cache:
            cache["k"], cache["v"] = _pad_kv(cache["k"], cfg, cap), _pad_kv(cache["v"], cfg, cap)
        caches.append(cache)
    return x, caches


def decode_stack(layers: List[Dict[str, Any]], x: torch.Tensor,
                 caches: List[Dict[str, Any]], pos: Union[int, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """One-token pass over the layer stack.  Every cache leaf is updated in
    place (see :func:`apply_attn_decode` and :func:`apply_ssm_decode`)."""
    kind = cfg.family
    for lp, cache in zip(layers, caches):
        xn = apply_norm(lp["ln1"], x, cfg)
        if kind == "ssm":
            y, _ = apply_ssm_decode(lp["ssm"], xn, cache["ssm"], cfg)
            x = x + y
            continue
        h, _ = apply_attn_decode(lp["attn"], xn, cache, pos, cfg)
        if kind == "hybrid":
            s, _ = apply_ssm_decode(lp["ssm"], xn, cache["ssm"], cfg)
            h = (h + s) / 2.0
        x = x + h
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)
    return x, caches
