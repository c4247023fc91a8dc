#!/usr/bin/env python3
"""Run one cell on several seeds, one process a run, one after another, and
report each metric's median and spread.

    python3 perfbench/tools/series.py --workload <cell> --seeds 11,12,13 --seconds 30 \
        [--trace 0|1] [--out results/perfbench/<file>.jsonl]

Each run is ``perfbench/run.py`` exactly as the benchmark's command runs it.
Every run's result line (or its error's tail) goes to ``--out`` as it ends.
The spread of a metric is the distance between its first and third
quartile over its median (``statistics.quantiles(values, n=4)``).
"""
from __future__ import annotations

import argparse
import json
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.lib.stats import spread  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    out = Path(args.out) if args.out else ROOT / "results" / "perfbench" / f"{args.workload}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    values, ok = {}, True
    for seed in [int(s) for s in args.seeds.split(",")]:
        cmd = [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        err_path = out.with_name(f"{out.stem}-{seed}-t{args.trace}.err")
        t0 = time.perf_counter()
        with open(err_path, "w") as err:
            p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
            try:
                stdout, _ = p.communicate(timeout=args.timeout)
                rc = p.returncode
            except subprocess.TimeoutExpired:
                p.send_signal(signal.SIGUSR1)            # run.py dumps every thread's stack
                time.sleep(3)
                p.kill()
                stdout, _ = p.communicate()
                rc = 124
        wall = time.perf_counter() - t0
        stderr = err_path.read_text()
        row = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": rc,
               "wall_s": wall, "stderr_tail": stderr[-3000:]}
        try:
            row["result"] = json.loads(stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            row["stdout_tail"] = stdout[-2000:]
            ok = False
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        res = row.get("result")
        if res is None or rc:
            print(f"seed {seed}: rc {rc}, no result\n{stderr[-1500:]}", flush=True)
            ok = False
            continue
        ok = ok and res["correct"]
        for k, v in res["metrics"].items():
            values.setdefault(k, []).append(v["value"])
        check = " ".join(f"{k} {c['value']:.4g}/{c['limit']:.4g}" for k, c in res["check"].items())
        mets = " ".join(f"{k} {v['value']:.6g}" for k, v in res["metrics"].items())
        print(f"seed {seed}: wall {wall:.1f} s correct {res['correct']} attempted "
              f"{res['attempted']} failed {res['failed']} | {mets} | {check}", flush=True)
    for k, vs in values.items():
        print(f"{k}: n {len(vs)} median {statistics.median(vs):.6g} "
              f"spread {spread(vs) if len(vs) >= 2 else 0.0:.4f} min {min(vs):.6g} "
              f"max {max(vs):.6g}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
