"""Worker processes for tests/test_torch_distributed.py (a helper module, not
a test file): each spawned rank joins a gloo process group on localhost,
runs the port's collectives on its seeded shards and saves what it got."""
from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.distributed as dist

B, S_LOCAL, K, N = 2, 4, 32, 48


def inputs(world: int):
    """The full operands every rank draws the same way (f32)."""
    rng = np.random.default_rng(zlib.crc32(f"collectives/{world}".encode()))
    x = torch.from_numpy(rng.standard_normal((B, S_LOCAL * world, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N * world)).astype(np.float32))
    xk = torch.from_numpy(rng.standard_normal((B, S_LOCAL, K * world)).astype(np.float32))
    wk = torch.from_numpy(rng.standard_normal((K * world, N)).astype(np.float32))
    g = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)) * (r + 1)
         for r in range(world)]
    return x, w, xk, wk, g


def run(rank: int, world: int, port: int, out_dir: str) -> None:
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.optim.compress import compressed_psum
    from repro_torch.parallel.collectives import psum_matmul, ring_allgather_matmul

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        x, w, xk, wk, g = inputs(world)
        ring = ring_allgather_matmul(x[:, rank * S_LOCAL:(rank + 1) * S_LOCAL],
                                     w[:, rank * N:(rank + 1) * N])
        psum = psum_matmul(xk[:, :, rank * K:(rank + 1) * K], wk[rank * K:(rank + 1) * K])
        comp = compressed_psum(g[rank])
        dm = device_mesh(Mesh("ranks", (("data", 1), ("model", world))), "cpu")
        torch.save({"ring": ring, "psum": psum, "compressed": comp,
                    "mesh": (tuple(dm.mesh.shape), dm.mesh_dim_names)},
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
