"""Load the reference package's parameters into the port.

:func:`params_from_reference` takes the JAX package's parameter tree as
numpy arrays — nested dicts, block leaves stacked with the layer axis first,
as ``repro.models.model.init_params`` builds them and ``jax.device_get``
returns them — and returns the port's parameters (the stacks unstacked
into one dict per layer: ``blocks``, an encoder-decoder's ``enc``, a VLM's
``xblocks`` by group and its ``blocks`` by group and layer, from their two
stacked axes).  The walk follows the port's spec tree, so every family it
runs comes across the same way, a MoE layer's ``moe`` leaves (the router
and the experts' stacked weights) included.  The same weights then run through both packages, which
is how the parity tests hold the port against the reference: a jax.random
stream cannot be replayed in torch.  :func:`train_state_from_reference`
does the same for a whole train state (parameters, Adam moments and
counters).  This module imports no jax.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .models.config import ModelConfig
from .models.layers import P, torch_dtype
from .models.model import param_specs, unstack_blocks

__all__ = ["params_from_reference", "train_state_from_reference"]


def _tensor(a: Any, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.array(a)  # an owned, writable copy (device_get may hand back read-only views)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no numpy-native torch mapping
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _convert(spec: Any, tree: Any, path: str, device: torch.device,
             dtype: Optional[torch.dtype]) -> Any:
    """Walk ``spec`` (the port's P tree) and ``tree`` together by key."""
    if isinstance(spec, P):
        if tuple(np.shape(tree)) != spec.shape:
            raise ValueError(f"{path}: shape {np.shape(tree)} != spec {spec.shape}")
        # a pinned leaf (the SSM's float32 A_log, dt_bias) keeps its pin
        return _tensor(tree, device, spec.with_dtype(dtype) if dtype is not None else None)
    if not isinstance(tree, dict) or set(tree) != set(spec):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path or '/'}: keys {got} != spec {sorted(spec)}")
    return {k: _convert(spec[k], tree[k], f"{path}/{k}", device, dtype) for k in spec}


def params_from_reference(tree: Dict[str, Any], cfg: ModelConfig,
                          device: Union[str, torch.device] = "cuda",
                          dtype: Optional[Any] = None) -> Dict[str, Any]:
    """Reference param tree (numpy) → the port's params on ``device``.

    ``dtype`` casts every leaf whose spec pins no dtype; a pinned leaf takes
    its pin (None keeps each array's dtype).  Raises if the tree's keys or
    leaf shapes differ from :func:`param_specs` of ``cfg``."""
    out = _convert(param_specs(cfg), tree, "", torch.device(device),
                   torch_dtype(dtype) if dtype is not None else None)
    return unstack_blocks(out, cfg)


def train_state_from_reference(state: Dict[str, Any], cfg: ModelConfig,
                               device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """The reference's train state (``repro.runtime.steps.init_train_state``
    as numpy: ``{"params", "opt": {"m", "v", "count"}, "step"}``) → the
    port's: parameters as :func:`params_from_reference` loads them (dtypes
    kept), ``m`` and ``v`` unstacked per layer in float32, ``count`` and
    ``step`` 0-d int32 tensors, all on ``device``."""
    device = torch.device(device)
    opt = state["opt"]
    scalar = lambda a: torch.tensor(int(np.asarray(a)), dtype=torch.int32, device=device)
    return {
        "params": params_from_reference(state["params"], cfg, device=device),
        "opt": {"m": params_from_reference(opt["m"], cfg, device=device, dtype="float32"),
                "v": params_from_reference(opt["v"], cfg, device=device, dtype="float32"),
                "count": scalar(opt["count"])},
        "step": scalar(state["step"]),
    }
