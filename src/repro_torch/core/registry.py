"""Smart-component registry — the annotation surface of MLOS.

``@tunable_component`` declares which parameters of a class are tunable and
which metrics it emits, and registers the component by name.  The decorated
class gains:

  * ``cls.mlos_meta``  — the :class:`ComponentMeta`;
  * ``self.settings`` — a flat dict of tunable values (declared defaults
    merged with constructor overrides), swapped by ``apply_settings``;
  * ``self.settings_for(workload)`` — the values for one workload context,
    resolved through :func:`repro_torch.core.configstore.resolve_settings`:
    override → keys set on this instance → stored entry → declared defaults.

The port keeps its own registry: its components carry ``torch_`` names, so
a process that imports the reference package as well (the parity tests)
holds both sets side by side.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

from .tunable import Tunable, TunableSpace

__all__ = ["MetricSpec", "ComponentMeta", "tunable_component", "get_component",
           "all_components", "default_instance", "settings_for"]


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One metric a component emits. ``fmt`` is the struct char ('d' float64, 'q' int64)."""

    name: str
    fmt: str = "d"
    description: str = ""

    def __post_init__(self) -> None:
        if self.fmt not in ("d", "q"):
            raise ValueError(f"metric {self.name}: fmt must be 'd' or 'q'")


@dataclasses.dataclass(frozen=True)
class ComponentMeta:
    name: str
    component_id: int
    space: TunableSpace
    metrics: Tuple[MetricSpec, ...]
    cls_qualname: str = ""


_REGISTRY: Dict[str, ComponentMeta] = {}
# First-constructed instance per component: the module singleton whose
# explicitly set keys the module-level settings_for honors.
_DEFAULT_INSTANCE: Dict[str, Any] = {}


def tunable_component(
    name: Optional[str] = None,
    tunables: Sequence[Tunable] = (),
    metrics: Sequence[MetricSpec] = (),
) -> Callable[[Type], Type]:
    """Class decorator declaring a smart component (see module docstring)."""

    space = TunableSpace(list(tunables))
    metric_tuple = tuple(metrics)

    def wrap(cls: Type) -> Type:
        comp_name = name or cls.__name__
        if comp_name in _REGISTRY:
            # Re-registration (e.g. module reload) replaces the entry but keeps the id.
            cid = _REGISTRY[comp_name].component_id
        else:
            cid = 1 + max([m.component_id for m in _REGISTRY.values()], default=0)
        meta = ComponentMeta(comp_name, cid, space, metric_tuple, cls.__qualname__)
        _REGISTRY[comp_name] = meta
        cls.mlos_meta = meta

        orig_init = cls.__init__

        @functools.wraps(orig_init)
        def __init__(self, *args: Any, **kwargs: Any) -> None:
            overrides = {k: kwargs.pop(k) for k in list(kwargs) if k in space}
            self.settings = space.validate(overrides)
            self._explicit_settings = set(overrides)
            _DEFAULT_INSTANCE.setdefault(comp_name, self)
            orig_init(self, *args, **kwargs)

        cls.__init__ = __init__

        def apply_settings(self, updates: Dict[str, Any]) -> None:
            """External hook: swap tunable values (agent-driven)."""
            merged = dict(self.settings)
            merged.update(updates)
            self.settings = space.validate(merged)
            self._explicit_settings = self._explicit_settings | set(updates)

        cls.apply_settings = apply_settings

        def settings_for(self, workload: str = "*") -> Dict[str, Any]:
            """Context-resolved settings for one workload signature:
            in-process override → keys set on this instance → stored entry
            → declared defaults.  A stored entry's unknown keys and
            out-of-domain values drop; override values are domain-checked,
            so a stale or mistyped override raises here rather than inside
            a kernel.  Resolution is cached per (store generation, context):
            a call reads no file."""
            from .configstore import resolve_settings

            explicit = {k: self.settings[k] for k in self._explicit_settings}
            return space.validate(resolve_settings(comp_name, workload, defaults=space.defaults(),
                                                   explicit=explicit, space=space))

        cls.settings_for = settings_for
        return cls

    return wrap


def get_component(name: str) -> ComponentMeta:
    return _REGISTRY[name]


def all_components() -> List[ComponentMeta]:
    return list(_REGISTRY.values())


def default_instance(name: str) -> Optional[Any]:
    """First-constructed instance of a component (the module singleton)."""
    return _DEFAULT_INSTANCE.get(name)


def settings_for(context: Any) -> Dict[str, Any]:
    """Resolve settings for a :class:`~repro_torch.core.configstore.Context`.

    Module-level twin of the per-instance ``settings_for`` for callers that
    hold a Context rather than a component instance.  All four coordinates
    are honored; a wildcard hardware/sw means this process's fingerprints.
    Keys set explicitly on the component's first-constructed instance
    outrank a stored entry, as they do through the instance."""
    from .configstore import WILDCARD, resolve_settings

    meta = get_component(context.component)
    inst = default_instance(context.component)
    # mloslint: disable=MLOS002 -- the resolution machinery reads the singleton's explicit tier
    explicit = ({k: inst.settings[k] for k in inst._explicit_settings}
                if inst is not None else None)
    s = resolve_settings(
        context.component, context.workload, defaults=meta.space.defaults(),
        explicit=explicit, space=meta.space,
        hardware=None if context.hardware == WILDCARD else context.hardware,
        sw=None if context.sw == WILDCARD else context.sw)
    return meta.space.validate(s)
