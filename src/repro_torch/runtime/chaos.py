"""Seeded, replayable fault injection for the training runtime.

The port of ``repro/runtime/chaos.py``; ``latest_step`` is the port's
(:mod:`repro_torch.runtime.checkpoint`), and :func:`respawn` runs whatever
child it is given (the port's training children).

Same contract as :mod:`repro_torch.runtime.traffic`: generator functions turn a
seed into a deterministic *plan* (a list of :class:`Fault`), and an
injector executes the plan against a live run.  The injector hooks
``run_training(chaos=...)`` at the top of every step and can

  * ``kill``          — SIGKILL this process (no atexit, no flush: the
                        honest crash),
  * ``suspend``       — stall the whole step (models preemption / GC pause),
  * ``corrupt_ckpt``  — scribble over the newest checkpoint's arrays.npz,
  * ``truncate_ckpt`` — tear the newest checkpoint mid-file,
  * ``data_delay``    — stall the input pipeline for ``arg`` seconds.

Kill faults must fire exactly once even though a resumed run re-executes
the scheduled step (resume restarts at the last checkpoint, which is at or
before the kill step — without memory the kill would loop forever).  The
injector therefore journals every fired fault to an append-only jsonl
*before* executing it; a respawned injector reloads the journal and skips.

Generators live in ``runtime`` (not ``benchmarks/``) so campaign measures
and tests can replay identical fault schedules without benchmark imports.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from .checkpoint import latest_step

__all__ = ["Fault", "ChaosInjector", "SCENARIOS", "kills", "torn_checkpoint",
           "slow_data", "mixed", "corrupt_checkpoint", "plan_to_json",
           "plan_from_json", "respawn"]

KINDS = ("kill", "suspend", "corrupt_ckpt", "truncate_ckpt", "data_delay")


@dataclasses.dataclass(frozen=True)
class Fault:
    at_step: int            # fires at the TOP of this step, before compute
    kind: str               # one of KINDS
    arg: float = 0.0        # seconds for suspend/data_delay; unused otherwise


def kills(seed: int, n_steps: int = 64, n_kills: int = 2) -> List[Fault]:
    """SIGKILLs at distinct random steps (never step 0: nothing to resume)."""
    rng = np.random.default_rng(seed)
    hi = max(2, n_steps)
    k = min(n_kills, hi - 1)
    steps = rng.choice(np.arange(1, hi), size=k, replace=False)
    return [Fault(int(s), "kill") for s in sorted(steps)]


def torn_checkpoint(seed: int, n_steps: int = 64, n_faults: int = 2) -> List[Fault]:
    """Alternating corrupt/truncate of the newest checkpoint at random steps."""
    rng = np.random.default_rng(seed)
    hi = max(2, n_steps)
    k = min(n_faults, hi - 1)
    steps = sorted(int(s) for s in rng.choice(np.arange(1, hi), size=k, replace=False))
    return [Fault(s, "corrupt_ckpt" if i % 2 == 0 else "truncate_ckpt")
            for i, s in enumerate(steps)]


def slow_data(seed: int, n_steps: int = 64, n_faults: int = 4,
              max_delay_s: float = 0.05) -> List[Fault]:
    rng = np.random.default_rng(seed)
    hi = max(2, n_steps)
    k = min(n_faults, hi - 1)
    steps = rng.choice(np.arange(1, hi), size=k, replace=False)
    return [Fault(int(s), "data_delay", float(rng.uniform(0.0, max_delay_s)))
            for s in sorted(steps)]


def mixed(seed: int, n_steps: int = 64) -> List[Fault]:
    """One of everything, disjoint steps: the integration smoke scenario."""
    rng = np.random.default_rng(seed)
    hi = max(len(KINDS) + 1, n_steps)
    steps = sorted(int(s) for s in
                   rng.choice(np.arange(1, hi), size=len(KINDS), replace=False))
    return [Fault(s, kind, 0.01 if kind in ("suspend", "data_delay") else 0.0)
            for s, kind in zip(steps, KINDS)]


SCENARIOS: Dict[str, Callable[..., List[Fault]]] = {
    "kills": kills,
    "torn_checkpoint": torn_checkpoint,
    "slow_data": slow_data,
    "mixed": mixed,
}


def plan_to_json(plan: Sequence[Fault]) -> str:
    return json.dumps([dataclasses.asdict(f) for f in plan])


def plan_from_json(s: str) -> List[Fault]:
    return [Fault(**d) for d in json.loads(s)]


def corrupt_checkpoint(root: str, step: Optional[int] = None,
                       truncate: bool = False) -> Optional[Path]:
    """Damage the arrays.npz of ``step`` (default: newest) in place.

    ``truncate`` tears the file at its midpoint (a writer died mid-stream);
    otherwise the zip header is overwritten (bit rot / torn sector).  Returns
    the damaged path, or None if there is no checkpoint to damage."""
    s = step if step is not None else latest_step(root)
    if s is None:
        return None
    npz = Path(root) / f"step_{s:08d}" / "arrays.npz"
    if not npz.exists():
        return None
    if truncate:
        size = npz.stat().st_size
        with open(npz, "r+b") as f:
            f.truncate(max(1, size // 2))
    else:
        with open(npz, "r+b") as f:
            f.write(b"\xff" * min(256, npz.stat().st_size))
    return npz


class ChaosInjector:
    """Executes a fault plan against a training run, firing each fault once.

    ``journal`` (jsonl, append-only) is what makes kill faults survivable:
    the fault is journaled *before* it executes, so the respawned process
    skips it and makes progress past the kill step."""

    def __init__(self, plan: Sequence[Fault], journal: Optional[str] = None):
        self.plan = list(plan)
        self.journal = Path(journal) if journal else None
        self._fired: Set[str] = set()
        if self.journal is not None and self.journal.exists():
            for line in self.journal.read_text().splitlines():
                if line.strip():
                    self._fired.add(json.loads(line)["fault"])

    @property
    def fired(self) -> Set[str]:
        return set(self._fired)

    def _mark(self, fault_id: str, step: int) -> None:
        self._fired.add(fault_id)
        if self.journal is None:
            return
        self.journal.parent.mkdir(parents=True, exist_ok=True)
        with open(self.journal, "a") as f:
            f.write(json.dumps({"fault": fault_id, "step": step,
                                "time": time.time()}) + "\n")
            f.flush()
            os.fsync(f.fileno())  # must hit disk BEFORE a kill executes

    def on_step(self, step: int, ckpt_dir: Optional[str] = None) -> None:
        for i, f in enumerate(self.plan):
            if f.at_step != step:
                continue
            fault_id = f"{i}:{f.kind}@{f.at_step}"
            if fault_id in self._fired:
                continue
            self._mark(fault_id, step)
            self._execute(f, ckpt_dir)

    def _execute(self, f: Fault, ckpt_dir: Optional[str]) -> None:
        if f.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif f.kind in ("suspend", "data_delay"):
            time.sleep(float(f.arg))
        elif f.kind == "corrupt_ckpt":
            if ckpt_dir:
                corrupt_checkpoint(ckpt_dir)
        elif f.kind == "truncate_ckpt":
            if ckpt_dir:
                corrupt_checkpoint(ckpt_dir, truncate=True)
        else:
            raise ValueError(f"unknown fault kind {f.kind!r}")


def respawn(argv: Sequence[str], max_restarts: int = 8,
            env: Optional[Dict[str, str]] = None) -> int:
    """Run ``argv`` to clean exit, restarting after abnormal deaths.

    The supervisor half of the kill harness: a child that SIGKILLs itself
    (chaos) exits with a signal status; rerun it until it exits 0.  Returns
    the number of restarts that were needed.  A child that fails
    ``max_restarts + 1`` times raises — a crash loop is a real failure, not
    a fault to absorb (cf. :class:`repro_torch.runtime.fault.RestartPolicy`)."""
    restarts = 0
    while True:
        proc = subprocess.run(list(argv), env=env)
        if proc.returncode == 0:
            return restarts
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(
                f"child failed {restarts} times (last rc={proc.returncode}); "
                "giving up")
