"""Instance-level kernel autotuning: MLOS tunes the port's own attention op.

The twin of the reference's ``benchmarks/kernel_autotune.py``: the
attention impl and tiles of ``torch_flash_attention`` are auto-parameters,
the objective is the measured time of the op on this machine.  The
reference's shapes (b2 s1024 h8 k4 d64 in float32; quick b1 s256 h4 k2),
budgets (14; quick 5), seed and optimizer (``bo_matern32``) are kept.  The
space is the port component's own: its tiles (``kernel.TILES``), and on
the card the Hopper kernel (``impl="kernel"``) beside the plain
implementations.  On the CPU ``kernel`` is left out: a CPU tensor never
reaches a kernel, so its time would be the plain version's.

Each candidate is built through the step registry
(:func:`repro_torch.launch.microbench.candidate`, key
``autotune.torch_flash_attention``) and timed by
:func:`~repro_torch.launch.microbench.median_time_us` (device-held on the
card, wall clock on the CPU).  Output: ``kernel_autotune.json`` under
``out_dir`` (by default ``results/torch/bench/``).

    PYTHONPATH=src python -m repro_torch.bench.kernel_autotune --quick --device cpu
    PYTHONPATH=src python -m repro_torch.bench.kernel_autotune            # on the card
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.optimizers import make_optimizer
from ..core.tunable import Categorical, TunableSpace
from ..kernels.flash_attention import kernel as attn_kernel
from ..kernels.flash_attention import ops as attn_ops
from ..launch.microbench import candidate, median_time_us, time_samples_us
from . import BENCH_ROOT, require_device

SHAPE = dict(b=2, s=1024, h=8, k=4, d=64)
QUICK_SHAPE = dict(b=1, s=256, h=4, k=2, d=64)
BUDGET = 14
SEED = 11
COMPONENT = "torch_flash_attention"


def space(device: Any) -> TunableSpace:
    """The reference twin's impls, the Hopper kernel on the card, and the
    component's tiles; the reference twin's default impl ("scan")."""
    impls = ("naive", "scan", "unrolled") + (("kernel",) if torch.device(device).type == "cuda"
                                             else ())
    return TunableSpace([Categorical("impl", "scan", impls),
                         Categorical("block_q", 64, attn_kernel.TILES),
                         Categorical("block_kv", 64, attn_kernel.TILES)])


def inputs(shape: Dict[str, int], device: Any):
    """float32 q, k, v drawn with numpy from seed 0."""
    b, s, h, k, d = shape["b"], shape["s"], shape["h"], shape["k"], shape["d"]
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)).to(device)
                 for shp in ((b, s, h, d), (b, s, k, d), (b, s, k, d)))


def _op(cfg: Dict[str, Any], shape: Dict[str, int]):
    return candidate(
        COMPONENT,
        lambda q, kk, vv: attn_ops.flash_attention(
            q, kk, vv, impl=cfg["impl"], block_q=cfg["block_q"], block_kv=cfg["block_kv"]),
        cfg, attn_ops.workload_signature(shape["b"], shape["s"], shape["s"], shape["d"]))


def run(budget: int = BUDGET, seed: int = SEED, quick: bool = False, *,
        device: Any = "cuda") -> Dict[str, Any]:
    device = require_device(device)
    shape = QUICK_SHAPE if quick else SHAPE
    sp = space(device)
    args = inputs(shape, device)
    base = median_time_us(_op(sp.defaults(), shape), *args)
    res: Dict[str, Any] = {"default_us": base, "trace": [], "quick": quick, "seed": seed,
                           "shape": dict(shape), "device": str(device),
                           "space": {t.name: list(t.choices) for t in sp}}
    opt = make_optimizer("bo_matern32", sp, seed=seed)
    best, best_cfg = base, sp.defaults()
    for _ in range(budget):
        cfg = opt.ask()
        t = median_time_us(_op(cfg, shape), *args)
        opt.tell(cfg, t)
        if t < best:
            best, best_cfg = t, cfg
        res["trace"].append({"config": cfg, "time_us": t})
    res["best_us"] = best
    res["best_config"] = best_cfg
    res["improvement_pct"] = 100.0 * (base - best) / base
    # sample-level re-measurement of the winner and the default: the trace
    # carries medians, the baseline gate wants raw distributions
    res["best_samples_us"] = time_samples_us(_op(best_cfg, shape), *args, warmup=1, reps=5)
    res["default_samples_us"] = time_samples_us(_op(sp.defaults(), shape), *args, warmup=1,
                                                reps=5)
    return res


def _write(res: Dict[str, Any], out_dir: Any) -> Dict[str, Any]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "kernel_autotune.json").write_text(json.dumps(res, indent=1))
    print(f"kernel autotune ({COMPONENT}, instance-level, {res['device']}):")
    print(f"  default={res['default_us']:.1f}us  best={res['best_us']:.1f}us "
          f"({res['improvement_pct']:.1f}% faster)  config={res['best_config']}")
    return res


def bench(quick: bool = False, seed: int = SEED, *, device: Any = "cuda",
          out_dir: Any = BENCH_ROOT) -> List[Any]:
    """Runner protocol: run, write the JSON, convert to BenchRecords."""
    from ..core.baseline import BenchRecord

    res = _write(run(budget=5 if quick else BUDGET, seed=seed, quick=quick, device=device),
                 out_dir)
    shape = res["shape"]
    wl = attn_ops.workload_signature(shape["b"], shape["s"], shape["s"], shape["d"])
    return [
        BenchRecord.for_component("kernel_autotune", "tuned_us", res["best_samples_us"],
                                  COMPONENT, wl, unit="us", config=res["best_config"]),
        BenchRecord.for_component("kernel_autotune", "default_us", res["default_samples_us"],
                                  COMPONENT, wl, unit="us"),
    ]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="small shape + budget")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=str(BENCH_ROOT))
    args = ap.parse_args(argv)
    _write(run(budget=5 if args.quick else BUDGET, seed=args.seed, quick=args.quick,
               device=args.device), args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
