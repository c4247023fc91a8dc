"""The card the port plans for, and the meshes it plans over.

The port of ``repro/launch/mesh.py``.  :data:`HW` holds the roofline
denominators of the one card the port runs on, an NVIDIA H100 SXM (NVIDIA's
data sheet, dense rates without sparsity, at the card's full 700 W), and its
identity as the config store keys it (:func:`repro_torch.core.configstore.
hardware_fingerprint` on that card).  A mesh is an ordered table of axis
sizes that touches no device: ``one`` is the single card the port runs on,
``single`` and ``multi`` are the reference's production meshes (data 16 ×
model 16, and pod 2 × data 16 × model 16) of H100s, eight to an HGX node.
:func:`device_mesh` builds a ``torch.distributed`` ``DeviceMesh`` of a
mesh's shape, and only inside a process group of that size.
:func:`traced_group` is such a group on one process: ``torch.distributed``'s
``fake`` backend at rank 0 of ``mesh.size`` ranks, whose collectives complete
without moving data.  Inside it rank 0's local program of a sharded step
runs, on ``meta`` tensors for the dry-run's traces or on the card.

A collective on a mesh of more than one node crosses the network: every
axis of ``single`` and ``multi`` spans more than one node (``model`` is 16
wide; ``data`` and ``pod`` are strided), so :func:`link_bw` is
``HW["internode_bw"]`` there and ``HW["nvlink_bw"]`` within one node.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import Dict, Iterator, Tuple

__all__ = ["HW", "Mesh", "MESHES", "get_mesh", "device_mesh", "traced_group", "link_bw",
           "NODE_CARDS", "spec_order"]

HW = {
    "name": "NVIDIA H100 80GB HBM3",
    "fingerprint": "cuda:NVIDIA_H100_80GB_HBM3:x1",
    "peak_flops_bf16": 989e12,      # dense bf16 on the tensor cores, FLOP/s
    "peak_flops_f32": 67e12,        # float32 outside the tensor cores, FLOP/s
    "hbm_bw": 3.35e12,              # HBM3, bytes/s
    "nvlink_bw": 450e9,             # NVLink 4, bytes/s each way, within an 8-card node
    # 400 Gb/s NDR InfiniBand, one NIC per H100 of an HGX/DGX node (data sheet,
    # not measured): a collective between nodes
    "internode_bw": 50e9,
    "memory_bytes": 85_017_493_504,  # torch.cuda.get_device_properties(0).total_memory
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named, ordered table of mesh-axis sizes."""

    name: str
    shape: Tuple[Tuple[str, int], ...]

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(self.shape)

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.shape)

    @property
    def size(self) -> int:
        return math.prod(n for _, n in self.shape)


MESHES: Dict[str, Mesh] = {
    "one": Mesh("one", (("data", 1), ("model", 1))),
    "single": Mesh("single", (("data", 16), ("model", 16))),
    "multi": Mesh("multi", (("pod", 2), ("data", 16), ("model", 16))),
}


NODE_CARDS = 8      # H100s of one HGX node, joined all to all by NVLink


def link_bw(mesh: Mesh) -> float:
    """Bytes/s of one card's link for a collective on ``mesh``: NVLink within
    one node, the network when the mesh spans several."""
    return HW["nvlink_bw"] if mesh.size <= NODE_CARDS else HW["internode_bw"]


def get_mesh(name: str) -> Mesh:
    if name not in MESHES:
        raise KeyError(f"unknown mesh {name!r}; choose from {sorted(MESHES)}")
    return MESHES[name]


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """A ``torch.distributed.device_mesh.DeviceMesh`` of ``mesh``'s shape over
    the ranks of the default process group, which must exist and hold
    exactly ``mesh.size`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"mesh {mesh.name!r} needs a process group of {mesh.size} ranks; "
                           "none is initialized")
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(f"mesh {mesh.name!r} has {mesh.size} devices; the process group "
                           f"has {dist.get_world_size()} ranks")
    return init_device_mesh(device_type, tuple(n for _, n in mesh.shape),
                            mesh_dim_names=mesh.axes)


@contextlib.contextmanager
def traced_group(mesh: Mesh, device_type: str = "cuda") -> Iterator:
    """A ``fake`` process group of ``mesh.size`` ranks at rank 0 and a
    ``DeviceMesh`` of ``mesh``'s axes and sizes over it, its dimensions in
    :func:`spec_order`; the group is destroyed on exit, whatever happens
    inside.  A group must not exist already (one program traces at a
    time).  ``device_type`` is the local tensors' device: ``meta`` for a
    trace (on a ``cpu`` mesh DTensor would replace each all-to-all by an
    all-gather, which gloo lacks and the card does not do), ``cuda`` for
    rank 0 on the card."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("traced_group: a process group is already initialized")
    # a dimension sharded over two mesh axes is gathered in two steps, which
    # DTensor warns of at every redistribution: the record counts both
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
        try:
            from torch.distributed.device_mesh import init_device_mesh

            names = spec_order(mesh)
            yield init_device_mesh(device_type, tuple(mesh.sizes[a] for a in names),
                                   mesh_dim_names=names)
        finally:
            dist.destroy_process_group()
    finally:
        log.setLevel(level)


def spec_order(mesh: Mesh) -> Tuple[str, ...]:
    """``mesh``'s axes in the order the sharding rules list them where one
    dimension is split over several (``("model", "data")``, ``("pod",
    "data")``): DTensor splits such a dimension in its mesh's order, so in
    this order a shard is JAX's ``PartitionSpec`` shard, and gathering the
    ``data`` part of a ``("model", "data")`` split is one all-gather (in the
    mesh's own order it would gather the whole and split it again)."""
    rank = {a: i for i, a in enumerate(("model", "pod", "data"))}
    return tuple(sorted(mesh.axes, key=lambda a: rank.get(a, len(rank))))
