"""A cell cut to a size a CPU test can run: two layers of width 64, a
vocabulary of 256, a 64-token cache of 4 slots, short chat lengths, the
program in float32; the weights drawn wider (std 0.2) so that the logits
spread as a full-size model's do.  (In bfloat16 at this size one flipped
choice of two experts of eight moves a logit by up to 0.9, as much as the
control does: the harness's logic is what these tests hold; the bfloat16
readings are the card's, at full size.)"""
from __future__ import annotations

import time

import torch

from perfbench.lib.spec import Run, Spec

SEED = 2**31 + 4242


def tiny_run(cell: str, seed: int = SEED, seconds: float = 2.0) -> Run:
    s = Spec(cell)
    p = s.config["program"]
    p.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
             dtype="float32")
    if p["family"] == "moe":
        p.update(moe_num_experts=8, moe_top_k=2, moe_d_ff=32)
    s.config["hf_config"] = {}
    s.config["init_std"] = 0.2
    if s.traffic["kind"] == "serve":
        s.traffic.update(prompt={"median": 16, "sigma": 0.8, "min": 4, "max": 32},
                         output={"median": 8, "sigma": 0.8, "min": 2, "max": 16}, block=16)
        if s.traffic["loop"] == "closed":
            s.traffic["clients"] = 8
        else:
            s.traffic.update(rate_per_s=20.0, lead_s=0.5, drain_s=5.0)
        s.cell["server"]["capacity"] = 64
        s.cell["components"]["torch_serve_batching"].update(max_batch=4, prefill_chunk=64)
        s.cell["check"]["sample"] = 4
    else:
        s.traffic.update(batch=2, seq=32)
    return Run(s, seed, seconds, False, torch.device("cpu"), time.perf_counter(), step="eager")
