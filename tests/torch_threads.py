"""``one_thread``: torch, OpenBLAS and OpenMP on one thread for a block.

A helper of the port's tests (no tests here).  The GP engine's CPU path is
thousands of small ops; with a pool of 8 threads in each of the suite's
workers they spin against each other (a 6-way run of the optimizer phase's
rehearsal took 448 s at 8 threads, 9 s at 1)."""
import contextlib

import torch


@contextlib.contextmanager
def one_thread():
    try:
        from threadpoolctl import threadpool_limits
    except ModuleNotFoundError:  # pragma: no cover - threadpoolctl ships with scipy's stack
        threadpool_limits = None
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if threadpool_limits is None:
            yield
        else:
            with threadpool_limits(1):
                yield
    finally:
        torch.set_num_threads(before)
