"""Transformer stacks: dense, SSM (Mamba-2) and hybrid (Hymba) blocks.

The port of ``repro/models/transformer.py`` for three families:

  dense   norm→attn→res, norm→mlp→res
  ssm     norm→mamba2→res
  hybrid  norm→(attn ∥ ssm: averaged)→res, norm→mlp→res   (Hymba)

The reference scans stacked parameters so its HLO stays O(1) in depth;
PyTorch runs eagerly, so the port holds one parameter dict per layer and
loops over them.  The other block kinds (MoE, encoder-decoder, VLM) come
with their families.

``stack_settings`` is the ``torch_layer_stack`` component.  It declares
the reference's tunable space so the port's tuned contexts keep it, and
nothing here reads it yet: ``remat`` (activation checkpointing) and
``loss_chunk`` (the cross-entropy chunk) belong to training, which the
serving slices do not run, and ``scan_layers`` has no torch meaning.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch

from ..core.registry import MetricSpec, tunable_component
from ..core.tunable import Categorical, Int
from .attention import apply_attn, apply_attn_decode, attn_params
from .config import ModelConfig
from .layers import P, apply_mlp, apply_norm, mlp_params, norm_params
from .ssm import apply_ssm, apply_ssm_decode, ssm_params

__all__ = ["FAMILIES", "stack_settings", "block_specs", "stack_specs", "forward_stack",
           "prefill_stack", "decode_stack"]

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


def _block(lp: Dict[str, Any], x: torch.Tensor,
           cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One full-sequence block.  Returns (x, the layer's decode state): K/V
    of every position for attention, the conv history and SSD state for an
    SSM mixer."""
    state: Dict[str, Any] = {}
    xn = apply_norm(lp["ln1"], x, cfg)
    if cfg.family == "ssm":
        y, state["ssm"] = apply_ssm(lp["ssm"], xn, cfg)
        return x + y, state
    h, (state["k"], state["v"]) = apply_attn(lp["attn"], xn, cfg, causal=True)
    if cfg.family == "hybrid":
        s, state["ssm"] = apply_ssm(lp["ssm"], xn, cfg)
        h = (h + s) / 2.0
    x = x + h
    return x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg), state


def forward_stack(layers: List[Dict[str, Any]], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence pass over the layer stack."""
    for lp in layers:
        x, _ = _block(lp, x, cfg)
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
