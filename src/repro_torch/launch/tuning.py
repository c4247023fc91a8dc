"""Bridge between the port's component settings and the launch CLIs.

The port of ``repro/launch/tuning.py``: one flat namespace of overrides
over the port's components.

  * ``component@workload.key=value`` — targets ONE workload context, e.g.
    ``torch_rmsnorm_kernel@r16384d1536.block_rows=4`` (the config store's
    in-process override tier; outranks stored entries for that context only)
  * ``component.key=value`` — sets the key on the component's module
    singleton (its explicit tier, for every workload)
  * ``optimizer.backend=torch`` — the optimizer pseudo-component: flips
    every BO the launch builds onto the torch GP engine
    (``make_optimizer``'s default), on ``optimizer.device`` (``cuda``, the
    default, or ``cpu``).  The reference's ``optimizer.backend=jax`` is
    refused.

Values are cast using the target component's tunable spec, not guessed from
their spelling.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from ..core import configstore
from ..core.optimizers import BACKENDS, optimizer_defaults, set_optimizer_defaults
from ..core.registry import get_component
from ..core.tunable import Categorical, Tunable, TunableSpace
from ..kernels.flash_attention.ops import attention_settings
from ..kernels.rmsnorm.ops import rmsnorm_settings
from ..kernels.ssd.ops import ssd_settings
from ..models.moe import moe_settings
from ..models.transformer import stack_settings
from ..runtime.serve_loop import serve_settings

__all__ = ["SINGLETONS", "OPTIMIZER_SPACE", "apply_overrides", "current_settings",
           "parse_override", "split_target"]

SINGLETONS = {
    "torch_flash_attention": attention_settings,
    "torch_ssd_kernel": ssd_settings,
    "torch_rmsnorm_kernel": rmsnorm_settings,
    "torch_moe_dispatch": moe_settings,
    "torch_layer_stack": stack_settings,
    "torch_serve_batching": serve_settings,
}

# Declared spec for the 'optimizer' pseudo-component so its overrides are
# cast and validated exactly like a registered component's.
OPTIMIZER_SPACE = TunableSpace([
    Categorical("backend", "numpy", BACKENDS,
                description="BO suggest engine for launch-constructed optimizers"),
    Categorical("device", "cuda", ("cuda", "cpu"),
                description="device of the torch BO engine"),
])


def _space_of(comp: str) -> TunableSpace:
    if comp == "optimizer":
        return OPTIMIZER_SPACE
    return get_component(comp).space


def _cast(t: Tunable, val: str) -> Any:
    """Cast a CLI string using the tunable's declared kind."""
    if t.kind == "categorical":
        for c in t.choices:
            if val == c or str(c) == val:
                return c
        lowered = {str(c).lower(): c for c in t.choices}
        if val.lower() in lowered:
            return lowered[val.lower()]
        raise ValueError(f"{t.name}: {val!r} not in {t.choices}")
    if t.kind == "int":
        return int(round(float(val)))
    return float(val)


def split_target(target: str) -> Tuple[str, str]:
    """'torch_flash_attention@b2q512k512d64' → ('torch_flash_attention',
    'b2q512k512d64'); plain component names return an empty workload."""
    comp, _, workload = target.partition("@")
    return comp, workload


def parse_override(s: str) -> Dict[str, Dict[str, Any]]:
    """'torch_layer_stack.remat=dots' → {'torch_layer_stack': {'remat': 'dots'}}.

    The context form keeps the target: 'comp@wl.key=v' → {'comp@wl': ...}.
    Raises for unknown components/tunables and uncastable values at parse
    time, before anything is applied.
    """
    key, _, val = s.partition("=")
    target, _, field = key.partition(".")
    comp, _ = split_target(target)
    space = _space_of(comp)
    if field not in space:
        raise ValueError(f"{comp}: unknown tunable {field!r} (have {space.names})")
    return {target: {field: _cast(space[field], val)}}


def apply_overrides(overrides: Dict[str, Dict[str, Any]]) -> None:
    for target, kv in overrides.items():
        comp, workload = split_target(target)
        space = _space_of(comp)
        kv = space.subset(list(kv)).validate(kv)
        if workload:
            configstore.default_store().set_override(comp, workload, kv)
        elif comp == "optimizer":
            set_optimizer_defaults(**kv)
        else:
            SINGLETONS[comp].apply_settings(kv)


def current_settings(contexts: bool = True) -> Dict[str, Dict[str, Any]]:
    """Flat settings report: each component's component-wide resolution
    under its plain name, plus (when ``contexts``) one ``comp@workload``
    entry per context the config store knows, each fully resolved."""
    out = {name: inst.settings_for(configstore.WILDCARD) for name, inst in SINGLETONS.items()}
    out["optimizer"] = optimizer_defaults()
    if contexts:
        for comp, workload in configstore.default_store().contexts():
            if comp not in SINGLETONS or not workload or workload == configstore.WILDCARD:
                continue
            out[f"{comp}@{workload}"] = SINGLETONS[comp].settings_for(workload)
    return out
