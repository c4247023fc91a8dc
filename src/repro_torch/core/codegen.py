"""The packed telemetry wire format of smart components.

The port of the wire-format half of ``repro/core/codegen.py``: every
telemetry record is ``struct``-packed as ``<II`` (component id, instance
id) followed by the component's declared metrics in order ('d' float64,
'q' int64).  :class:`~repro_torch.core.agent.AgentMux` routes records on
that header.  The generated hook modules (``generate_source`` /
``load_generated``) are not ported yet.
"""
from __future__ import annotations

import struct
from typing import Any, Dict

from .registry import ComponentMeta

__all__ = ["TELEMETRY_HEADER_FMT", "pack_telemetry", "unpack_telemetry", "peek_component_id"]

# Every telemetry message starts with: component_id (u32), instance_id (u32).
TELEMETRY_HEADER_FMT = "<II"


def _metric_fmt(meta: ComponentMeta) -> str:
    return TELEMETRY_HEADER_FMT + "".join(m.fmt for m in meta.metrics)


def pack_telemetry(meta: ComponentMeta, instance_id: int, metrics: Dict[str, Any]) -> bytes:
    vals = [metrics[m.name] for m in meta.metrics]
    return struct.pack(_metric_fmt(meta), meta.component_id, instance_id, *vals)


def unpack_telemetry(meta: ComponentMeta, payload: bytes) -> Dict[str, Any]:
    vals = struct.unpack(_metric_fmt(meta), payload)
    out = {"component_id": vals[0], "instance_id": vals[1]}
    for m, v in zip(meta.metrics, vals[2:]):
        out[m.name] = v
    return out


def peek_component_id(payload: bytes) -> int:
    return struct.unpack_from("<I", payload, 0)[0]
