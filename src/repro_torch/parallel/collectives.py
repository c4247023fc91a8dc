"""Explicit compute/communication-overlap collectives over ``torch.distributed``.

The port of ``repro/parallel/collectives.py``.  The ring **collective
matmul** (Wang et al., "Overlap communication with dependent computation"):
instead of ``all_gather(x) @ w`` (a bandwidth burst followed by idle
compute), the gather becomes a ring of point-to-point exchanges, each
overlapped with the partial product of the shard a rank holds.  The psum
matmul is the reduce side of Megatron tensor parallelism: a local partial
product and one ``all_reduce``.

Each function takes this rank's shards and a process group (default: the
default group); on a world of one, or with no process group, both are the
plain product.  The products stay ``torch.matmul``: the reference computes
them with ``einsum``, outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ring_allgather_matmul", "psum_matmul", "world"]


def world(group=None) -> tuple:
    """(rank, size) of this process in ``group``; (0, 1) without a process
    group."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """y = all_gather_seq(x) @ w_shard as a compute/communication ring.

    x: (b, s_local, k), this rank's sequence shard (sequence parallel);
    w: (k, n_local), this rank's column shard (tensor parallel).  Returns
    (b, s_local · world, n_local): every rank's rows, in rank order, against
    this rank's columns, without ever holding the gathered activation.  At
    step i a rank holds the shard of rank (r − i) mod n, multiplies it while
    sending it on to rank r + 1 and receiving the next from rank r − 1."""
    import torch.distributed as dist

    rank, n = world(group)
    if n == 1:
        return torch.matmul(x, w)
    b, s_local, _ = x.shape
    y = x.new_empty((b, s_local * n, w.shape[-1]))
    cur = x.contiguous()
    nxt = torch.empty_like(cur)
    send_to = dist.get_global_rank(group, (rank + 1) % n) if group is not None else (rank + 1) % n
    recv_from = (dist.get_global_rank(group, (rank - 1) % n) if group is not None
                 else (rank - 1) % n)
    for i in range(n):
        reqs = []
        if i < n - 1:                            # the exchange overlaps the product
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, cur, send_to, group),
                                           dist.P2POp(dist.irecv, nxt, recv_from, group)])
        src = (rank - i) % n                     # the rank whose shard `cur` is
        y[:, src * s_local:(src + 1) * s_local] = torch.matmul(cur, w)
        for r in reqs:
            r.wait()
        cur, nxt = nxt, cur
    return y


def psum_matmul(x: torch.Tensor, w: torch.Tensor, group: Optional[object] = None) -> torch.Tensor:
    """y = x @ w with the contraction dim sharded on both sides: x (b, s,
    k_local), w (k_local, n); a local partial product and one ``all_reduce``
    (sum).  Every rank returns the full (b, s, n)."""
    import torch.distributed as dist

    _, n = world(group)
    y = torch.matmul(x, w)
    if n > 1:
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y
