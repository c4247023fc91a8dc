"""The assigned input-shape set and per-(arch × shape) cell applicability.

A copy of ``repro/launch/shapes.py``: the four shapes every architecture is
planned at, and which cells run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..configs import ALL_ARCHS
from ..models.config import ModelConfig

__all__ = ["SHAPES", "Shape", "cell_status", "all_cells"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


def cell_status(cfg: ModelConfig, shape: Shape) -> Tuple[bool, str]:
    """(runs?, reason).  long_500k needs sub-quadratic decode: SSM/hybrid
    state or a sliding window ⇒ O(window) cache.  Pure full-attention archs
    skip it (a 512k dense-KV read per token is the quadratic-family case the
    assignment excludes); recorded as SKIP rows."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 512k decode needs sub-quadratic attention (skip per assignment)"
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    cells = []
    for arch in ALL_ARCHS:
        for shape in SHAPES.values():
            cells.append((arch, shape.name))
    return cells
