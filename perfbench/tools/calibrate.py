#!/usr/bin/env python3
"""Read a cell's comparison on several seeds in one process: the program's
numbers and verdict, and those of the control (the reference with float8
products) put in the program's place and, for a training cell, of a
half-batch fault, each judged by the cell's own limits, as the limits in
``perfbench/workloads/<cell>.json`` are set from them.  ``--fault`` plants
a serving fault of :mod:`perfbench.tools.faults` in the timed path instead.

    python3 perfbench/tools/calibrate.py --workload <cell> --seeds 21,22,23 --seconds 40
    python3 perfbench/tools/calibrate.py --workload <cell> --seeds 24,25 --seconds 20 \
        --fault cache_unchanged

Each seed runs the cell as a run does (set-up, the window at the cell's own
load, the check); the benchmark's own runs never compute the control.  One
JSON line a seed goes to standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import run as bench

    bench._environment()
    import torch

    from perfbench.lib import program
    from perfbench.lib.spec import Run, Spec
    from perfbench.tools import faults

    if args.fault:
        module, name, planted = faults.SERVE[args.fault]()
        setattr(module, name, planted)

    spec = Spec(args.workload)
    if not torch.cuda.is_available():
        print("calibration reads the card; no CUDA device", file=sys.stderr)
        return 2
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        r = Run(spec, seed, args.seconds, False, torch.device("cuda", 0), time.perf_counter())
        res = bench.run_cell(r, control=not args.fault)
        program.release()
        row = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "wall_s": time.perf_counter() - t0, "correct": res["correct"],
               "check": res["check"], "stand_ins": res.get("stand_ins"),
               "readings": res["readings"], "metrics": res["metrics"]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
