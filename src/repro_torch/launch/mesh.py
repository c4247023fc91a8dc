"""The card the port plans for, and the meshes it plans over.

The port of ``repro/launch/mesh.py``.  :data:`HW` holds the roofline
denominators of the one card the port runs on, an NVIDIA H100 SXM (NVIDIA's
data sheet, dense rates without sparsity, at the card's full 700 W), and its
identity as the config store keys it (:func:`repro_torch.core.configstore.
hardware_fingerprint` on that card).  A mesh is an ordered table of axis
sizes that touches no device: ``one`` is the single card the port runs on,
``single`` and ``multi`` are the reference's production meshes (data 16 ×
model 16, and pod 2 × data 16 × model 16), planned here by their sharding
rules only.  :func:`device_mesh` builds a ``torch.distributed``
``DeviceMesh`` of a mesh's shape, and only inside a process group of that
size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

__all__ = ["HW", "Mesh", "MESHES", "get_mesh", "device_mesh"]

HW = {
    "name": "NVIDIA H100 80GB HBM3",
    "fingerprint": "cuda:NVIDIA_H100_80GB_HBM3:x1",
    "peak_flops_bf16": 989e12,      # dense bf16 on the tensor cores, FLOP/s
    "peak_flops_f32": 67e12,        # float32 outside the tensor cores, FLOP/s
    "hbm_bw": 3.35e12,              # HBM3, bytes/s
    "nvlink_bw": 450e9,             # NVLink 4, bytes/s each way, for meshes of more cards
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
