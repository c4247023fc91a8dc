"""One config-resolution facade: the public API for reading and writing
tuned settings.

The port of ``repro/core/config.py``.  Four surfaces reach a component's
settings: its instance's ``settings`` dict, per-instance or module
``settings_for``, agent-driven ``apply_settings`` and raw
:class:`~repro_torch.core.configstore.ConfigStore` lookups.  This module puts
them behind one surface:

  * :func:`resolve` — the read path: in-process override ≻ explicit live
    settings ≻ persisted tuned entry ≻ declared defaults, for any registered
    component, keyed by workload (and optionally explicit hardware/software
    coordinates);
  * :func:`override` / :func:`clear_override` — the ephemeral write path
    (one process's hand on the dial; never persists);
  * :func:`promote` — the durable write path, through the store's gated
    promotion;
  * :func:`apply_global` / :func:`global_settings` — the deprecated
    module-global ``settings`` tier.  Both emit :class:`DeprecationWarning`:
    the tier is workload-blind and process-local.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict

from .configstore import WILDCARD, Context, context_for, default_store
from .registry import default_instance, get_component
from .registry import settings_for as _settings_for_context

__all__ = [
    "resolve", "override", "clear_override", "promote",
    "apply_global", "global_settings",
]

_DEPRECATION = (
    "the module-global `settings` dict tier is deprecated: it is workload-blind "
    "and process-local.  Use repro_torch.core.config.override(component, workload, ...) "
    "for one-process dials or repro_torch.core.config.promote(...) for durable tuned "
    "entries, and read through repro_torch.core.config.resolve(component, workload=...)."
)


def resolve(component: str, workload: str = WILDCARD, *,
            hardware: str = WILDCARD, sw: str = WILDCARD) -> Dict[str, Any]:
    """The effective settings of ``component`` @ ``workload``.

    Tiers, strongest first: in-process override (:func:`override`) → keys
    explicitly set on the live singleton this process → persisted tuned
    entry (exact context → relaxed hw/sw → component-wide ``"*"`` workload,
    never across hardware platforms) → declared defaults.  Wildcard
    ``hardware``/``sw`` mean this process's fingerprints.  Returns a fresh
    dict.  Raises ``KeyError`` for an unregistered component.
    """
    return dict(_settings_for_context(Context(component, workload, hardware, sw)))


def override(component: str, workload: str, settings: Dict[str, Any]) -> None:
    """Pin ``settings`` for ``component`` @ ``workload`` in this process.

    The in-process tier: outranks everything, persists nothing.  Values are
    validated against the component's declared space up front, so a typo'd
    key or out-of-domain value fails here."""
    meta = get_component(component)
    unknown = [k for k in settings if k not in meta.space]
    if unknown:
        raise KeyError(f"{component}: unknown tunable(s) {unknown}")
    validated = {k: meta.space[k].validate(v) for k, v in settings.items()}
    default_store().set_override(component, workload, validated)


def clear_override(component: str, workload: str = WILDCARD) -> None:
    """Drop this process's override for ``component`` @ ``workload``."""
    default_store().clear_override(component, workload)


def promote(component: str, settings: Dict[str, Any], workload: str = WILDCARD,
            **gate: Any) -> bool:
    """Durably promote ``settings`` through the store's gated write path:
    ``default_store().promote(context_for(component, workload), ...)`` with
    the same keywords (``rpi``, ``metrics``, ``baseline``, ``samples``,
    ``mode``, ``tolerance``, ``alpha``, ``provenance``).  True iff accepted."""
    return default_store().promote(context_for(component, workload), settings, **gate)


def apply_global(component: str, settings: Dict[str, Any]) -> None:
    """DEPRECATED: mutate the component's module-global settings tier."""
    warnings.warn(_DEPRECATION, DeprecationWarning, stacklevel=2)
    inst = default_instance(component)
    if inst is None:
        raise KeyError(f"{component}: no live instance to apply global settings to")
    inst.apply_settings(settings)


def global_settings(component: str) -> Dict[str, Any]:
    """DEPRECATED: read the raw module-global settings dict (workload-blind)."""
    warnings.warn(_DEPRECATION, DeprecationWarning, stacklevel=2)
    inst = default_instance(component)
    # mloslint: disable=MLOS002 -- this deprecated accessor is the global tier itself
    s = inst.settings if inst is not None else get_component(component).space.defaults()
    return dict(s)
