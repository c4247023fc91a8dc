"""Cold against warm start: what the built-kernel cache saves a fresh process.

The twin of the cold/warm half of the reference's
``benchmarks/compile_cold_warm.py``.  A fresh interpreter of the reference
pays XLA's trace and compile for its first jitted train step; a fresh
interpreter of the port pays ``nvcc`` for every kernel its first step
loads (:mod:`repro_torch.kernels.build`), plus the first autograd pass.
This benchmark starts fresh interpreters and measures that first step's
wall time (the interpreter's imports done before it), the reference's
reduced OLMo-1B train step of
:mod:`repro_torch.runtime.steps` at batch 4 x seq 64 on ``device`` (the
card unless the caller asks for the CPU):

  * COLD: each child builds into an empty kernel root of its own, so it
    compiles the kernels its first step loads (one ``nvcc`` per source)
    and writes nothing into the shared ``build/kernels/<hw>/<sw>/``;
  * WARM: the children share one root, primed first by a child that is
    not measured.

Each child gets its root as an argument (``--build-root``, which the child
hands to :func:`repro_torch.kernels.build.set_root`); every temporary root
is removed afterwards.  "The cache makes restarts faster" is then a
``stats.compare`` verdict over real process boundaries.  A child prints its
first step's seconds and :func:`~repro_torch.core.telemetry.
compile_cache_counters` (the step registry's hits and misses).  To keep the
run short, every child starts at once: each imports, sets up its state and
batch, and waits; once all are ready they take their first steps one at a
time, in order, so no measurement overlaps another child's start-up or
step.  On the CPU nothing is built, and the two sides differ only by
noise.

The reference's second half, the ``xla_runtime`` flag pseudo-component
tuned through child re-exec, has no torch meaning and is not ported.

Output: ``compile_cold_warm.json`` under ``out_dir`` (by default
``results/torch/bench/``).

    PYTHONPATH=src python -m repro_torch.bench.compile_cold_warm --quick          # on the card
    PYTHONPATH=src python -m repro_torch.bench.runner --quick --only compile_cold_warm

Child mode (internal): ``--child --build-root <dir>``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..core import stats
from . import BENCH_ROOT, require_device

SRC = Path(__file__).resolve().parents[2]
CHILD_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
CHILD_TIMEOUT_S = 600.0
BATCH, SEQ = 4, 64
READY = "ready"


# -- the child ------------------------------------------------------------------
def child_main(build_root: str, device: str, wait=None) -> Dict[str, Any]:
    """One fresh interpreter's first train step: build into ``build_root``,
    set up the reduced OLMo-1B state and batch, print ``ready``, wait for
    ``wait()`` (the parent's turn signal; none: go at once), then time the
    first step to the end of its device work.

    The setup imports what the step would otherwise import at its first
    call: ``torch.utils.checkpoint`` (the layers' ``remat``) pulls in
    ``torch._dynamo`` lazily, hundreds of modules and seconds of
    interpreter work that no cache changes.  The reference's child likewise imports its
    framework before its timer starts."""
    import torch
    import torch._dynamo  # noqa: F401 — see the docstring

    from ..configs import get_config
    from ..core.telemetry import compile_cache_counters
    from ..data.pipeline import PackedBatcher, SyntheticCorpus
    from ..kernels import build
    from ..kernels.flash_attention import kernel as attn_kernel
    from ..runtime.steps import init_train_state, train_step_for

    # the counters are process-wide and a caller in process may have raised
    # them before: report what this child's step lookup and step add
    counters0 = compile_cache_counters()
    launches0 = attn_kernel.flash_attention.launches
    build.set_root(build_root)
    dev = require_device(device)
    cfg = get_config("olmo-1b").reduced().validate()
    batch = {k: torch.from_numpy(v).to(device=dev, dtype=torch.long)
             for k, v in PackedBatcher(SyntheticCorpus(cfg.vocab_size, seed=0),
                                       BATCH, SEQ).batch_at(0).items()}
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    step = train_step_for(cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(READY, flush=True)
    if wait is not None:
        wait()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, 1.0)
    loss = float(metrics["loss"])              # reads the step's result: its device work is done
    first_step_s = time.perf_counter() - t0
    built = sorted(p.name for p in build.build_dir().glob("*.so")) if build.build_dir().is_dir() \
        else []
    counters = {k: v - counters0[k] for k, v in compile_cache_counters().items()}
    return {"first_step_s": first_step_s, "loss": loss, "counters": counters,
            "build_dir": str(build.build_dir()), "libraries": built,
            "launches": attn_kernel.flash_attention.launches - launches0, "device": str(dev)}


# -- the parent -----------------------------------------------------------------
def _env() -> Dict[str, str]:
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, **CHILD_ENV,
            "PYTHONPATH": str(SRC) + (os.pathsep + path if path else "")}


class Child:
    """A fresh interpreter running :func:`child_main` on ``root``: started
    at once, measured when :meth:`measure` is called."""

    def __init__(self, root: Path, device: str):
        self.root = root
        self.err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.bench.compile_cold_warm", "--child",
             "--build-root", str(root), "--device", device],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.err, text=True,
            env=_env())

    def _fail(self, what: str) -> RuntimeError:
        self.err.seek(0)
        return RuntimeError(f"cold/warm child ({self.root}) {what}:\n{self.err.read()[-3000:]}")

    def wait_ready(self) -> None:
        line = self.proc.stdout.readline()
        if line.strip() != READY:
            self.proc.kill()
            self.proc.wait()
            raise self._fail(f"did not get ready (printed {line!r})")

    def measure(self) -> Dict[str, Any]:
        try:
            out, _ = self.proc.communicate(input="go\n", timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise self._fail("timed out")
        if self.proc.returncode != 0:
            raise self._fail(f"exited {self.proc.returncode}")
        self.err.close()
        return json.loads(out.strip().splitlines()[-1])


def _children(plan: List[Path], device: str) -> List[Dict[str, Any]]:
    """One child per root in ``plan``, all started at once; once every one
    is ready, each takes its first step alone, in the plan's order."""
    children: List[Child] = []
    try:
        for root in plan:
            children.append(Child(root, device))
        for child in children:
            child.wait_ready()
        return [child.measure() for child in children]
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait()


def run(reps: int = 7, seed: int = 7, *, device: Any = "cuda") -> Dict[str, Any]:
    """``reps`` cold children (an empty root each), one unmeasured priming
    child, then ``reps`` warm children sharing the primed root.  The
    temporary roots are removed."""
    device = str(require_device(device))
    tmp = Path(tempfile.mkdtemp(prefix="cold_warm_"))
    try:
        cold_roots = [tmp / f"cold{i}" for i in range(reps)]
        warm_root = tmp / "warm"
        print(f"  cold: {reps} fresh interpreters, each with an empty kernel root; "
              f"then priming {warm_root} (unmeasured); then warm: {reps} fresh "
              f"interpreters against it")
        t0 = time.perf_counter()
        out = _children(cold_roots + [warm_root] * (reps + 1), device)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cold, priming, warm = out[:reps], out[reps], out[reps + 1:]
    cold_s = [c["first_step_s"] for c in cold]
    warm_s = [w["first_step_s"] for w in warm]
    cmp = stats.compare(cold_s, warm_s, mode="min", seed=seed)
    print(f"  first step: cold {stats.median(cold_s):.2f}s → warm {stats.median(warm_s):.2f}s "
          f"({cmp.verdict}, effect {cmp.effect:+.0%}); {len(out)} children in {wall:.1f}s")
    return {
        "seed": seed, "reps": reps, "device": device, "batch": BATCH, "seq": SEQ,
        "cold_s": cold_s, "warm_s": warm_s, "priming_s": priming["first_step_s"],
        "verdict": cmp.to_dict(), "counters": warm[-1]["counters"],
        "cold_libraries": [c["libraries"] for c in cold],
        "cold_build_dirs": [c["build_dir"] for c in cold],
        "warm_build_dir": warm[-1]["build_dir"],
        "launches": [c["launches"] for c in out], "wall_s": wall,
        "roots_removed": not tmp.exists(),
    }


def _write(res: Dict[str, Any], quick: bool, out_dir: Any) -> Dict[str, Any]:
    res["quick"] = quick
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "compile_cold_warm.json").write_text(json.dumps(res, indent=1))
    print(f"compile cold/warm → {out / 'compile_cold_warm.json'}")
    return res


def bench(quick: bool = False, seed: int = 7, *, device: Any = "cuda",
          out_dir: Any = BENCH_ROOT) -> List[Any]:
    """Runner protocol: run, write the JSON, convert to BenchRecords.  Six
    a side is the floor at which a clean cold/warm separation reliably
    clears the median permutation test at alpha 0.05 (the reference's
    finding: at five a side p hovers at the threshold)."""
    from ..core.baseline import BenchRecord

    res = _write(run(reps=6 if quick else 7, seed=seed, device=device), quick, out_dir)
    return [
        BenchRecord.for_component("compile_cold_warm", "first_step_cold_s", res["cold_s"],
                                  "compilecache", "train_first_step", unit="s"),
        BenchRecord.for_component("compile_cold_warm", "first_step_warm_s", res["warm_s"],
                                  "compilecache", "train_first_step", unit="s"),
    ]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="six children a side")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=str(BENCH_ROOT))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--build-root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        res = child_main(args.build_root, args.device, wait=sys.stdin.readline)
        print(json.dumps(res), flush=True)
        return 0
    _write(run(reps=6 if args.quick else 7, seed=args.seed, device=args.device), args.quick,
           args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
