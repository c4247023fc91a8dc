"""Public SSD op (Mamba-2): MLOS-tunable implementation + chunk dispatch.

The port of ``repro/kernels/ssd/ops.py``.  ``ssd_settings`` is the smart
component ``torch_ssd_kernel``; its tunables are resolved per call for the
call's workload signature, as in the reference.  ``impl="kernel"`` (the
default) is the Hopper kernel of ``kernel.py``, whose ``chunk`` is one of
the lengths it was compiled for (the result does not depend on the chunk);
the plain implementations take the same chunk, aligned to the sequence by
halving.  The reference quietly turns ``pallas`` into ``chunked`` off the
TPU or when an initial state is given; here ``kernel`` on a CUDA tensor
runs the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

from ...core.configstore import bucket_pow2
from ...core.registry import MetricSpec, tunable_component
from ...core.tunable import Categorical
from . import kernel, ref

__all__ = ["ssd", "ssd_decode_step", "ssd_settings", "SsdKernelSettings", "workload_signature"]

# calls that resolved impl "kernel": those a kernel is built for, and those of a
# ``meta`` trace (the dry-run) whose shape none is (a sharded program's shard),
# which the trace runs plain; on a CUDA tensor such a shape raises in the kernel
DISPATCHED = {"kernel": 0, "no_kernel": 0}


@tunable_component(
    name="torch_ssd_kernel",
    tunables=(
        Categorical("impl", default="kernel",
                    choices=("naive", "chunked", "chunked_unrolled", "kernel"),
                    description="SSD algorithm / kernel path"),
        Categorical("chunk", default=64, choices=kernel.CHUNKS,
                    description="SSD block-decomposition chunk length"),
    ),
    metrics=(MetricSpec("time_us", "d"),),
)
class SsdKernelSettings:
    pass


ssd_settings = SsdKernelSettings()
_align = ref.align_chunk


def workload_signature(b: int, s: int, h: int) -> str:
    """Bucketed (batch, seq, heads) — the chunk decomposition trades per-chunk
    matmul size against the inter-chunk scan length, so the best chunk tracks
    the sequence bucket."""
    return f"b{bucket_pow2(b)}s{bucket_pow2(s)}h{h}"


def ssd(x, dt, A, B, C, D=None, *, impl: Optional[str] = None, chunk: Optional[int] = None,
        init_state=None, return_state: bool = False, workload: Optional[str] = None):
    wl = workload or workload_signature(x.shape[0], x.shape[1], x.shape[2])
    s = ssd_settings.settings_for(wl)
    impl = impl or s["impl"]
    chunk = chunk or s["chunk"]
    if (impl == "kernel" and x.device.type == "meta"
            and not kernel.supports(tuple(x.shape), tuple(B.shape), x.dtype)):
        impl = "chunked"          # traced only: the card has no kernel for this shape
        DISPATCHED["no_kernel"] += 1
    elif impl == "kernel":
        DISPATCHED["kernel"] += 1
        # the kernel masks a ragged last chunk itself: its chunk need not divide
        return kernel.ssd(x, dt, A, B, C, D, chunk=chunk, init_state=init_state,
                          return_state=return_state)
    if impl == "naive":
        return ref.ssd_naive_scan(x, dt, A, B, C, D, init_state=init_state,
                                  return_state=return_state)
    if impl in ("chunked", "chunked_unrolled"):
        # PyTorch runs the chunk loop eagerly either way: "unrolled" is the
        # reference's name for the same arithmetic, kept for the tunable space
        return ref.ssd_chunked(x, dt, A, B, C, D, chunk=_align(chunk, x.shape[1]),
                               init_state=init_state, return_state=return_state)
    raise ValueError(f"unknown ssd impl {impl!r}")


ssd_decode_step = ref.ssd_decode_step
