"""Context resolution for the port's smart components.

The slice of the reference's config store (``repro/core/configstore.py``)
that the serving path needs, with this process's own coordinates:

  * :func:`bucket_pow2` — workload-signature bucketing;
  * :func:`hardware_fingerprint` / :func:`sw_fingerprint` — the CUDA device
    name × count and the torch / CUDA / Python versions, so a tune taken on
    the H100 is filed under the H100 (the reference's versions ask jax);
  * :func:`resolve_settings` — in-process override → explicit settings →
    declared defaults.

The persisted tier (one JSON file per component, promotion behind the
stats gate) and campaigns come with the MLOS loop on the GPU.
"""
from __future__ import annotations

import functools
import sys
from typing import Any, Dict, Optional, Tuple

__all__ = ["bucket_pow2", "hardware_fingerprint", "sw_fingerprint", "context_for",
           "set_override", "clear_override", "resolve_settings"]

WILDCARD = "*"


def bucket_pow2(n: int) -> int:
    """Round up to a power of two (floor 1) — workload-signature bucketing.

    Call shapes bucket so that e.g. ``s=500`` and ``s=512`` share one tuned
    entry while ``s=512`` and ``s=4096`` do not.
    """
    return 1 << max(0, (int(n) - 1).bit_length())


@functools.lru_cache(maxsize=1)
def hardware_fingerprint() -> str:
    """``cuda:<device name>:x<count>`` of this process's GPUs, or the host's
    CPU architecture when no GPU is visible."""
    import platform

    import torch

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0).replace(" ", "_")
        return f"cuda:{kind}:x{torch.cuda.device_count()}"
    return f"cpu:{platform.machine()}:x1"


@functools.lru_cache(maxsize=1)
def sw_fingerprint() -> str:
    """Library + interpreter versions a tuned config was produced under."""
    import torch

    cuda = torch.version.cuda or "none"
    return f"torch-{torch.__version__}/cuda-{cuda}/py-{sys.version_info.major}.{sys.version_info.minor}"


def context_for(component: str, workload: str = WILDCARD) -> Dict[str, str]:
    """The four coordinates of one tuned configuration on this process."""
    return {"component": component, "workload": workload,
            "hardware": hardware_fingerprint(), "sw": sw_fingerprint()}


# (component, workload) -> pinned values: the operator's hand on the dial for
# one process; never persisted.
_OVERRIDES: Dict[Tuple[str, str], Dict[str, Any]] = {}


def set_override(component: str, workload: str, kv: Dict[str, Any]) -> None:
    _OVERRIDES.setdefault((component, workload), {}).update(kv)


def clear_override(component: str, workload: str) -> None:
    _OVERRIDES.pop((component, workload), None)


def resolve_settings(component: str, workload: str = WILDCARD,
                     defaults: Optional[Dict[str, Any]] = None,
                     explicit: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Settings for a (component, workload) context.  Tiers, strongest first:

      1. in-process override for exactly this context (:func:`set_override`);
      2. ``explicit`` — values set on the component instance this process;
      3. ``defaults`` — the declared tunable defaults.

    """
    override = _OVERRIDES.get((component, workload))
    merged = dict(defaults or {})
    merged.update(explicit or {})
    merged.update(override or {})
    return merged
