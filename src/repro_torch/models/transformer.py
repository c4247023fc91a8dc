"""Transformer stack, dense kind: norm→attn→res, norm→mlp→res.

The port of ``repro/models/transformer.py`` for the dense family.  The
reference scans stacked parameters so its HLO stays O(1) in depth; PyTorch
runs eagerly, so the port holds one parameter dict per layer and loops over
them.  The other block kinds (MoE, SSM, hybrid, encoder-decoder, VLM) come
with their families.

``stack_settings`` is the ``torch_layer_stack`` component.  It declares
the reference's tunable space so the port's tuned contexts keep it, and
nothing here reads it yet: ``remat`` (activation checkpointing) and
``loss_chunk`` (the cross-entropy chunk) belong to training, which this
serving slice does not run, and ``scan_layers`` has no torch meaning.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch

from ..core.registry import MetricSpec, tunable_component
from ..core.tunable import Categorical, Int
from .attention import apply_attn, apply_attn_decode, attn_params
from .config import ModelConfig
from .layers import P, apply_mlp, apply_norm, mlp_params, norm_params

__all__ = ["stack_settings", "block_specs", "stack_specs", "forward_stack",
           "prefill_stack", "decode_stack"]


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
    """P-spec tree for ONE dense layer."""
    if cfg.family != "dense":
        raise NotImplementedError(f"the port serves the dense family; {cfg.name} is {cfg.family}")
    return {"ln1": norm_params(cfg), "attn": attn_params(cfg),
            "ln2": norm_params(cfg), "mlp": mlp_params(cfg)}


def stack_specs(specs: Any, n: int) -> Any:
    """Add a leading ("layers",) axis to every leaf — the reference's stacked
    layout, which :func:`repro_torch.models.model.init_params` unstacks."""
    if isinstance(specs, P):
        return P((n, *specs.shape), ("layers", *specs.logical), specs.init, specs.scale,
                 specs.dtype)
    return {k: stack_specs(v, n) for k, v in specs.items()}


# ------------------------------------------------------------------- blocks
def _block(lp: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h, _ = apply_attn(lp["attn"], apply_norm(lp["ln1"], x, cfg), cfg, causal=True)
    x = x + h
    return x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)


def forward_stack(layers: List[Dict[str, Any]], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence pass over the layer stack."""
    for lp in layers:
        x = _block(lp, x, cfg)
    return x


def prefill_stack(layers: List[Dict[str, Any]], x: torch.Tensor, cfg: ModelConfig,
                  cache_capacity: int) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Full-sequence pass that also fills each layer's KV cache with the last
    ``cache_capacity`` positions.  Returns (x, per-layer caches)."""
    sl = x.shape[1]
    cap = cfg.cache_len(cache_capacity)

    def pad_kv(k: torch.Tensor) -> torch.Tensor:
        # keep last `cap` positions, right-pad if the sequence is shorter
        if k.shape[1] >= cap:
            # ring-buffer layout for windowed caches: token t lives at slot t % cap
            return k[:, -cap:] if not cfg.window else torch.roll(k[:, -cap:], sl % cap, dims=1)
        pad = torch.zeros((k.shape[0], cap - k.shape[1], *k.shape[2:]), dtype=k.dtype,
                          device=k.device)
        return torch.cat([k, pad], dim=1)  # slots [0, sl) filled; pos continues at sl

    caches = []
    for lp in layers:
        h, (k, v) = apply_attn(lp["attn"], apply_norm(lp["ln1"], x, cfg), cfg, causal=True)
        caches.append({"k": pad_kv(k), "v": pad_kv(v)})
        x = x + h
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)
    return x, caches


def decode_stack(layers: List[Dict[str, Any]], x: torch.Tensor,
                 caches: List[Dict[str, torch.Tensor]], pos: Union[int, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One-token pass over the layer stack; each layer's cache is updated in
    place (see :func:`apply_attn_decode`)."""
    for lp, cache in zip(layers, caches):
        h, _ = apply_attn_decode(lp["attn"], apply_norm(lp["ln1"], x, cfg), cache, pos, cfg)
        x = x + h
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)
    return x, caches
