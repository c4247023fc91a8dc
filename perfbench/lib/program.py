"""What the harness takes from the port (``repro_torch``): its model config
type, its parameter layout, the registry through which its settings are
pinned, and its compile-cache counters.  Weights and inputs are the
harness's own, drawn here from the seed on the card.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, Tuple

import torch

# the published config.json key and the port's ModelConfig field it must equal
HF_FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
             "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
             "vocab_size": "vocab_size", "rope_theta": "rope_theta",
             "tie_word_embeddings": "tie_embeddings", "num_experts": "moe_num_experts",
             "num_experts_per_tok": "moe_top_k"}


def sub_seed(seed: int, stream: str) -> int:
    """A 60-bit seed for one stream of draws of a run's ``--seed``."""
    return int(hashlib.sha256(f"{seed}:{stream}".encode()).hexdigest()[:15], 16)


def model_config(config: Dict[str, Any]):
    """The port's ModelConfig for a configuration file: its ``program``
    section, held against the published keys in ``hf_config``."""
    from repro_torch.models.config import ModelConfig

    prog = dict(config["program"])
    cfg = ModelConfig(name=config["name"], source=config["source"], **prog).validate()
    hf = config["hf_config"]
    pairs = dict(HF_FIELDS, intermediate_size="moe_d_ff" if cfg.is_moe else "d_ff")
    for key, field in pairs.items():
        if key in hf and key not in config["reduced"] and hf[key] != getattr(cfg, field):
            raise ValueError(f"{config['name']}: {key} = {hf[key]} in the source, "
                             f"{field} = {getattr(cfg, field)} in the program section")
    return cfg


def pin(components: Dict[str, Dict[str, Any]]) -> None:
    """Pin every tunable of each named component of the port (the keys set
    on its instance outrank any stored entry), so nothing is resolved from a
    config store.  A component must be given whole."""
    # the modules that define the components the serve and train paths resolve
    import repro_torch.kernels.flash_attention.ops  # noqa: F401
    import repro_torch.models.moe  # noqa: F401
    import repro_torch.models.transformer  # noqa: F401
    import repro_torch.runtime.serve_loop  # noqa: F401
    from repro_torch.core import registry

    for name, values in components.items():
        space = registry.get_component(name).space
        missing = set(space.names) - set(values)
        if missing:
            raise ValueError(f"{name}: pin every tunable; missing {sorted(missing)}")
        registry.default_instance(name).apply_settings(values)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _leaves(v)]
    return [tree]


def _fill(tree: Any, take) -> Any:
    """``tree``'s structure (empty dicts kept) with each leaf ``take(leaf)``."""
    if isinstance(tree, dict):
        return {k: _fill(v, take) for k, v in tree.items()}
    return take(tree)


def draw_weights(cfg, seed: int, std: float, device: torch.device
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(raw, params): every weight drawn in one call from a generator on
    ``device`` seeded by ``seed``, normal with ``std`` in the configuration's
    dtype (bfloat16 for every cell), norm scales 1.  ``raw`` is the port's stacked layout (a leading layer axis on
    every block leaf, views into one buffer); ``params`` is the port's tree
    of the same tensors (one dict per layer)."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import dtype_of

    specs = M.param_specs(cfg)
    total = 0
    for p in _leaves(specs):
        if p.dtype is not None:
            raise ValueError(f"{cfg.name}: leaf {p} pins its dtype; the harness draws one dtype")
        if p.init not in ("normal", "embed", "ones"):
            raise ValueError(f"{cfg.name}: no draw for a leaf initialised {p.init!r}")
        total += -(-math.prod(p.shape) // 64) * 64        # each leaf 128-byte aligned
    flat = torch.empty(total, dtype=dtype_of(cfg), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    flat.normal_(0.0, std, generator=gen)
    offset = 0

    def take(p):
        nonlocal offset
        t = flat[offset:offset + math.prod(p.shape)].view(p.shape)
        offset += -(-math.prod(p.shape) // 64) * 64
        return t.fill_(1.0) if p.init == "ones" else t

    raw = _fill(specs, take)
    return raw, M.unstack_blocks(raw, cfg)


def sync(dev: torch.device) -> None:
    """Wait for the card (nothing to wait for elsewhere)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cache_captures() -> float:
    """Graph captures so far in this process (the port's registry)."""
    from repro_torch.core import compilecache

    return compilecache.cache_counters()["captures"]


def release() -> None:
    """Free what the port's registry keeps after its owners are gone."""
    import gc

    from repro_torch.core import compilecache

    gc.collect()
    compilecache.drop_handed_over()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
