"""Assigned-architecture registry: ``get_config("<id>")`` / ``--arch <id>``.

Each module defines CONFIG with the exact public numbers from the assignment
(citation in ``source``).  ``ALL_ARCHS`` is the canonical order used by the
dry-run sweep and EXPERIMENTS.md tables.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ALL_ARCHS: List[str] = [
    "olmoe-1b-7b",
    "mixtral-8x22b",
    "olmo-1b",
    "deepseek-67b",
    "starcoder2-15b",
    "command-r-35b",
    "hymba-1.5b",
    "seamless-m4t-medium",
    "mamba2-780m",
    "llama-3.2-vision-11b",
]

_MODULES: Dict[str, str] = {a: a.replace("-", "_").replace(".", "_") for a in ALL_ARCHS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ALL_ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG.validate()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ALL_ARCHS}
