"""Public RMSNorm op: MLOS-tunable implementation + launch shape.

The port of ``repro/kernels/rmsnorm/ops.py``.  ``rmsnorm_settings`` is the
smart component ``torch_rmsnorm_kernel``; its tunables are resolved per
call for the call's workload signature.  ``impl="kernel"`` (the default)
is the Hopper kernel of ``kernel.py`` with its ``block_rows`` rows per CUDA
block and ``row_threads`` threads per row; on a CPU tensor it goes to the
plain version.  ``impl="plain"`` is the plain PyTorch version on any device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...core.configstore import bucket_pow2
from ...core.registry import MetricSpec, tunable_component
from ...core.tunable import Categorical
from . import kernel, ref

__all__ = ["rmsnorm", "rmsnorm_settings", "RmsNormSettings", "workload_signature"]


@tunable_component(
    name="torch_rmsnorm_kernel",
    # The default launch shape is the `kernels` grid's best at r16384d1536
    # on an H100 80GB HBM3 (PERF.md, RMSNorm row).
    tunables=(
        Categorical("impl", default="kernel", choices=("plain", "kernel"),
                    description="RMSNorm path: plain PyTorch or the Hopper kernel"),
        Categorical("block_rows", default=1, choices=kernel.BLOCK_ROWS,
                    description="rows normalized by one CUDA block"),
        Categorical("row_threads", default=32, choices=kernel.ROW_THREADS,
                    description="threads that own one row"),
    ),
    metrics=(MetricSpec("time_us", "d"),),
)
class RmsNormSettings:
    pass


rmsnorm_settings = RmsNormSettings()


def workload_signature(rows: int, d: int) -> str:
    """Bucketed (total rows, feature dim) — the op is row-parallel, so the
    flattened row count is the workload axis that moves the best tile."""
    return f"r{bucket_pow2(rows)}d{d}"


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, residual: Optional[torch.Tensor] = None,
            eps: float = 1e-5, *, impl: Optional[str] = None, block_rows: Optional[int] = None,
            row_threads: Optional[int] = None, workload: Optional[str] = None) -> torch.Tensor:
    wl = workload or workload_signature(math.prod(x.shape[:-1]), x.shape[-1])
    s = rmsnorm_settings.settings_for(wl)
    impl = impl or s["impl"]
    if impl == "kernel":
        return kernel.rmsnorm(x, scale, residual, eps, block_rows=block_rows or s["block_rows"],
                              row_threads=row_threads or s["row_threads"])
    if impl == "plain":
        return ref.rmsnorm(x, scale, residual, eps)
    raise ValueError(f"unknown rmsnorm impl {impl!r}")
