#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process a run: set up (weights from the seed, the program built and
every shape the cell's traffic uses warmed), measure for ``--seconds``, read
the metrics (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics under the profiler with ``--trace 1``), then free the
program's state and check what the window produced against the plain
reference.  The last line of standard output is the result; the numbers
compared, each with its limit, are the last lines of standard error and
the result's last key.  Without a CUDA card with as many devices as the
cell asks for, it prints no result and exits 2.  Build and kernel caches
stay in ``build/`` of the checkout.
"""
from __future__ import annotations

import argparse
import faulthandler
import importlib
import json
import os
import signal
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no JAX through a library."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def run_cell(r, control: bool = False) -> dict:
    """Set up, measure, read the metrics and check one run (``r``: a
    :class:`perfbench.lib.spec.Run`); returns the result object."""
    import torch

    from perfbench.lib.spec import log, metric_reader
    from perfbench.reference.model import strict_f32

    strict_f32()
    spec = r.spec
    kind = importlib.import_module(f"perfbench.kinds.{spec.cell['kind']}")
    rec = kind.run(r)
    metrics = {}
    for m in (spec.per_layer() if r.trace else spec.end_to_end()):
        v = metric_reader(m["name"])(rec)
        if v is None:
            if not r.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            print(f"per-layer metric {m['name']} read nothing", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted, failed = kind.counts(rec)
    dev = r.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": spec.chips, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    breakdown = None
    if rec.trace is not None:
        device["busy_s"], device["window_s"] = rec.trace["busy_s"], rec.trace["window_s"]
        breakdown = {"device_ops": rec.trace["device_ops"], "idle_gaps": rec.trace["idle_gaps"]}
    log("metrics read; checking against the reference")
    numbers = kind.check(rec, r, control=control)
    log(f"check: {numbers}")
    limits = spec.cell["check"]["limits"]
    correct, check = decide(numbers, limits, failed)
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["readings"] = {k: v for k, v in numbers.items()
                       if k not in limits and not isinstance(v, dict)}
    stand_ins = {k: v for k, v in numbers.items() if isinstance(v, dict)}
    if stand_ins:               # the control and faults, each in the program's place
        out["stand_ins"] = {k: dict(zip(("correct", "check"), decide(v, limits)), numbers=v)
                            for k, v in stand_ins.items()}
    out["check"] = check
    return out


def decide(numbers: dict, limits: dict, failed: int = 0) -> tuple:
    """(correct, {number: {"value", "limit"}}): every number within its
    limit and no request or step failed."""
    check = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in check.values()) and failed == 0, check


def main(argv=None) -> int:
    started = _process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from perfbench.lib.spec import Run, Spec

    spec = Spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    r = Run(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), started)
    out = run_cell(r)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.register(signal.SIGUSR1)           # a stuck run's stacks, on request
    sys.exit(main())
