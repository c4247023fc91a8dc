"""Training cells: the port's train step (``runtime/steps.train_step_for``) on
seeded batches.

Set-up draws the weights, builds one train state (the port's parameters in
bfloat16, its AdamW moments) and one step with the cell's pinned
hyperparameters, and drives that state through the first ``check.steps``
steps on the mix's batches of those steps; it keeps what the comparison
needs (each step's loss, the first gradient's per-leaf norms as AdamW holds
it and the gradient itself, kept on the card in bfloat16 until the check,
the per-leaf norms of the parameters' change) and hands the same state
to the window.  The window then runs steps on the next batches for
``--seconds``, a CUDA event before and after each, and ends in a
synchronize: every step launched in it is counted, and its time is the
window's.

:func:`check` frees the state and follows the first steps with the plain
reference (:func:`perfbench.reference.train.follow`).
"""
from __future__ import annotations

import time
import types
from typing import Any, Dict

import torch

from ..lib import program, trace
from ..lib.spec import log
from ..lib.compare import train_gaps
from ..reference.control import FP8
from ..reference.model import Hyper, RefConfig
from ..reference.train import follow
from ..traffic.generator import LMBatches

B1 = 0.9            # AdamW's first-moment decay, the port's and the reference's


def _named(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(_named(v, f"{prefix}{k}."))
    return out


def _norms(named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in named.items()}


def run(r) -> types.SimpleNamespace:
    spec, cell, dev = r.spec, r.spec.cell, r.device
    cfg = program.model_config(spec.config)
    m = RefConfig.from_file(spec.config)
    program.pin(cell["components"])
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.steps import TrainHyper, train_step_for

    tr = cell["trainer"]
    _, params = program.draw_weights(cfg, r.seed, spec.config["init_std"], dev)
    step_fn = train_step_for(cfg, TrainHyper(**tr["hyper"]), microbatches=tr["microbatches"])
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    data = LMBatches(spec.traffic, m.vocab, r.seed)
    rec = types.SimpleNamespace(kind="train", model=m, batch=data.batch, seq=data.seq,
                                tokens_per_step=data.tokens_per_step, seed=r.seed)

    # set-up: the first steps, read for the comparison
    named0 = _named(params)
    start = {k: t.clone() for k, t in named0.items()}
    losses = []
    for i in range(cell["check"]["steps"]):
        state, met = step_fn(state, data.batch_at(i, dev))
        losses.append(met["loss"])
        if i == 0:                      # AdamW's first moment holds (1 − b1) × the gradient
            first = {k: t / (1.0 - B1) for k, t in _named(state["opt"]["m"]).items()}
            grads = _norms(first)
            first = {k: t.to(torch.bfloat16) for k, t in first.items()}
    now = _named(state["params"])
    change = {k: float(torch.linalg.vector_norm(now[k].float() - start[k].float())) for k in now}
    del start, now, named0
    rec.prog = {"loss": [float(x) for x in losses], "grad": grads, "grads": first,
                "change": change}
    program.sync(dev)
    log(f"set-up: {len(losses)} checked steps, losses {rec.prog['loss']}")

    win = rec.window = trace.Window()
    marks = []
    with trace.profiler(r.trace) as prof:
        win.open()
        k = cell["check"]["steps"]
        while time.perf_counter() - win.t0 < r.seconds:
            with trace.label("data.batch"):
                batch = data.batch_at(k, dev)
            ev = _event(dev)
            with trace.label("train.step"):
                state, _ = step_fn(state, batch)
            marks.append((ev, _event(dev)))
            k += 1
        program.sync(dev)
        win.close()
    rec.setup_s = win.t0 - r.started
    log(f"window {win.seconds:.1f} s, {len(marks)} steps")
    rec.window_steps = len(marks)
    rec.step_ms = [a.elapsed_time(b) for a, b in marks] if dev.type == "cuda" else []
    rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec.trace = trace.reduce(prof, win) if prof is not None else None
    if rec.trace is not None:
        log(f"trace reduced: {len(rec.trace['ops'])} device operations in the window")
    rec.state, rec.data, rec.cfg = state, data, cfg
    return rec


def _event(dev: torch.device):
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def reference_inputs(rec, r):
    """Free the program's state (its first gradient moved to the host); the
    initial weights drawn again from the seed and the first steps' batches."""
    rec.prog["grads"] = {k: t.cpu() for k, t in rec.prog["grads"].items()}
    rec.state = None
    program.release()
    w0, _ = program.draw_weights(rec.cfg, r.seed, r.spec.config["init_std"], r.device)
    batches = [(b["tokens"], b["labels"]) for b in
               (rec.data.batch_at(i, r.device) for i in range(r.spec.cell["check"]["steps"]))]
    return w0, batches, Hyper(**r.spec.cell["trainer"]["hyper"])


def check(rec, r, control: bool = False) -> Dict[str, Any]:
    """The program's first steps against the reference's (and, ``control``,
    under ``"control"`` and ``"half_batch"`` the numbers of the control and
    of a half-batch fault, each put in the program's place)."""
    w0, batches, hp = reference_inputs(rec, r)
    ref = follow(w0, rec.model, batches, hp)
    out: Dict[str, Any] = train_gaps(rec.prog, ref)
    if control:
        for name, kw in (("control", {"prec": FP8}),
                         ("half_batch", {"rows": range(batches[0][0].shape[0] // 2)})):
            out[name] = train_gaps(follow(w0, rec.model, batches, hp, **kw), ref)
    return out


def counts(rec):
    """(attempted, failed): the window's steps; a step fails if a loss of the
    checked steps is not finite."""
    bad = sum(not (abs(x) < float("inf")) for x in rec.prog["loss"])
    return rec.window_steps, bad
