"""Batched serving: continuous batching and an MLOS-tuned admission size.

The twin of the reference's ``examples/serve_decode.py``.  A reduced
OLMo-1B (random weights from seed 0) is served greedily by the continuous
:class:`~repro_torch.runtime.serve_loop.BatchedServer` over a queue of 24
synthetic requests a trial, and an MLOS agent core (in this process, BO
over ``max_batch`` of ``torch_serve_batching``, 6 trials) picks the batch
size that maximizes the measured tokens/s: the serving analogue of the
paper's workload-dependent spinlock tuning.  Each trial's server gets its
``max_batch`` as a pinned setting; on the card its steps run as CUDA
graphs.  Tokens/s and latency are host wall-clock readings of the run.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode               # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..bench import require_device
from ..configs import get_config
from ..core.agent import AgentCore, make_session
from ..core.tunable import Int, TunableSpace
from ..models import model as M
from ..runtime.serve_loop import COMPONENT, BatchedServer

TRIALS = 6
REQUESTS = 24
CAPACITY = 64
MAX_NEW_TOKENS = 12


def enqueue(server: BatchedServer, n: int, rng: np.random.Generator) -> None:
    for _ in range(n):
        plen = int(rng.integers(4, 12))
        server.submit(rng.integers(2, 250, size=plen).astype(np.int32))


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    cfg = get_config("olmo-1b").reduced().validate()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    rng = np.random.default_rng(0)
    space = TunableSpace([Int("max_batch", 4, 1, 16, log=True)])
    agent = AgentCore(make_session(COMPONENT, "tokens_per_s", space=space, mode="max",
                                   optimizer="bo_matern32", budget=TRIALS))
    cfg_now = agent.ask()

    print(f"serving {REQUESTS} requests per trial on {device}; the agent tunes the "
          f"admission batch size")
    trials = []
    for trial in range(TRIALS):
        server = BatchedServer(params, cfg, capacity=CAPACITY, settings=dict(cfg_now),
                               device=device)
        enqueue(server, REQUESTS, rng)
        m = server.run(max_new_tokens=MAX_NEW_TOKENS)
        print(f"  trial {trial}: max_batch={cfg_now['max_batch']:<3d} "
              f"→ {m['tokens_per_s']:8.1f} tok/s  p50 {m['p50_latency_s'] * 1e3:6.0f} ms")
        trials.append({"max_batch": cfg_now["max_batch"], "tokens_per_s": m["tokens_per_s"],
                       "p50_latency_s": m["p50_latency_s"], "prefills": server.prefill_calls,
                       "prefill_captures": server.prefill_captures,
                       "tokens": sum(len(r.tokens) for r in server.results.values())})
        cfg_now = agent.observe_value(cfg_now, m["tokens_per_s"])
    print(f"best: {agent.best.config} ({-agent.best.value:.1f} tok/s)")
    return {"trials": trials, "best_config": agent.best.config,
            "best_tokens_per_s": -agent.best.value, "device": str(device)}


if __name__ == "__main__":
    main()
