"""The figure suite: the paper's Figures 3–5 and the framework benchmarks.

The twin of the reference's ``benchmarks/run.py``: one module per figure
(:mod:`.fig3_hashtable`, :mod:`.fig4_counters`, :mod:`.fig5_spinlock`),
then the multi-instance agent (:mod:`.multi_instance`) and the kernel
autotune (:mod:`.kernel_autotune`) twins, each with its wall time.  The
BO arms and the kernel autotune run on ``device`` (the card unless the
caller asks for the CPU); the figures' objectives are host work.  The
reference's ``roofline_table`` reads the dry-run sweep, which the port does
not have yet: the suite says so in one line and goes on.  Outputs go under
``out_dir`` (by default ``results/torch/bench/``).

    PYTHONPATH=src python -m repro_torch.bench.run                  # on the card
    PYTHONPATH=src python -m repro_torch.bench.run --device cpu --backend numpy
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

from . import BENCH_ROOT, require_device

ROOFLINE_PENDING = ("roofline_table: not ported yet; it reads the dry-run and roofline layer, "
                    "which the port does not have (ROADMAP A6)")


def suite(*, device: Any = "cuda", backend: str = "torch",
          out_dir: Any = BENCH_ROOT) -> Dict[str, Any]:
    """Run every benchmark of the suite in the reference's order; returns
    each one's result and wall seconds."""
    from . import fig3_hashtable, fig4_counters, fig5_spinlock, kernel_autotune, multi_instance

    device = str(require_device(device))
    steps: List[Any] = [
        ("fig3_hashtable", lambda: fig3_hashtable.write(
            fig3_hashtable.run(backend=backend, device=device), out_dir,
            backend=backend, device=device)),
        ("fig4_counters", lambda: fig4_counters.write(fig4_counters.run(), out_dir)),
        ("fig5_spinlock", lambda: fig5_spinlock.write(
            fig5_spinlock.run(backend=backend, device=device), out_dir,
            backend=backend, device=device)),
        ("multi_instance", lambda: multi_instance.run(device=device, out_dir=out_dir)),
        ("kernel_autotune", lambda: kernel_autotune.main(
            ["--device", device, "--out-dir", str(out_dir)])),
    ]
    out: Dict[str, Any] = {}
    t0 = time.perf_counter()
    print("=" * 72)
    print(f"MLOS PyTorch/CUDA benchmark suite on {device}")
    print("=" * 72)
    for name, fn in steps:
        print(f"\n--- {name} " + "-" * (60 - len(name)))
        t = time.perf_counter()
        res = fn()
        out[name] = {"result": res, "wall_s": time.perf_counter() - t}
        print(f"    [{out[name]['wall_s']:.1f}s]")
    print("\n--- roofline_table " + "-" * 46)
    print(f"    {ROOFLINE_PENDING}")
    out["wall_s"] = time.perf_counter() - t0
    print(f"\ntotal: {out['wall_s']:.1f}s")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default="torch", choices=("torch", "numpy"),
                    help="the BO arms' surrogate")
    ap.add_argument("--out-dir", default=str(BENCH_ROOT))
    args = ap.parse_args(argv)
    suite(device=args.device, backend=args.backend, out_dir=args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
