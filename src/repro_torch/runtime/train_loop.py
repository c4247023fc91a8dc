"""The training loop: data → step → telemetry → checkpoint → (MLOS agent).

The port of ``repro/runtime/train_loop.py``: Figure 1 of the paper over a
PyTorch train job on the card.  The loop emits per-step telemetry (loss,
step time) onto the MLOS channel (pass ``channel=``), the side-car agent
(:class:`repro_torch.core.agent.AgentProcess`) retunes ``lr_scale`` live
through ``lr_scale_source``, checkpointing is async and atomic with
interval / mode / retention resolved from ``torch_train_checkpoint``, and
the data stream prefetches through ``torch_data_pipeline``.  On restart
the loop resumes from the newest *loadable* step with a deterministic data
stream (``PackedBatcher.batch_at`` is stateless), skipping torn
checkpoints.

Fault wiring: per-step times feed a :class:`StragglerDetector` whose events
(and any you inject via a shared detector) are dispatched to ``on_fault``
every 8 steps; a :mod:`repro_torch.runtime.chaos` injector hooks
``chaos.on_step`` at the top of every step to kill / suspend / corrupt /
delay on schedule.

The loop runs on ``device`` (the card unless the caller asks for the CPU)
and nowhere else: a CUDA device that is not there raises.  A resumed run
is bit-identical to an uninterrupted one on the same device, because the
step is deterministic there (see :mod:`repro_torch.models.model`).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..core.configstore import bucket_pow2
from ..core.registry import MetricSpec, get_component, tunable_component
from ..core.telemetry import TelemetryEmitter
from ..core.tracking import Tracker
from ..core.tunable import Float
from ..data.pipeline import PackedBatcher, PrefetchingBatcher, SyntheticCorpus
from ..models.config import ModelConfig
from .checkpoint import AsyncCheckpointer, ckpt_settings, latest_step, restore_checkpoint, state_kb
from .checkpoint import workload_signature as ckpt_workload_signature
from .fault import FaultEvent, StragglerDetector
from .steps import TrainHyper, init_train_state, train_step_for

__all__ = ["run_training", "train_settings", "workload_signature"]


@tunable_component(
    name="torch_train_loop",
    tunables=(
        Float("lr_scale", default=1.0, low=0.0625, high=16.0, log=True),
    ),
    metrics=(MetricSpec("loss", "d"), MetricSpec("step_time_s", "d")),
)
class TrainLoopSettings:
    pass


train_settings = TrainLoopSettings()


def workload_signature(global_batch: int, seq_len: int, d_model: int) -> str:
    return (f"b{bucket_pow2(max(1, global_batch))}"
            f"s{bucket_pow2(max(1, seq_len))}d{bucket_pow2(max(1, d_model))}")


def run_training(
    cfg: ModelConfig,
    *,
    n_steps: int,
    global_batch: int,
    seq_len: int,
    hyper: Optional[TrainHyper] = None,
    microbatches: int = 1,
    ckpt_dir: Optional[str] = None,
    ckpt_every: Optional[int] = None,
    tracker: Optional[Tracker] = None,
    experiment: str = "train",
    on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
    on_fault: Optional[Callable[[FaultEvent], None]] = None,
    lr_scale_source: Optional[Callable[[], float]] = None,
    channel: Optional[Any] = None,
    chaos: Optional[Any] = None,
    straggler_detector: Optional[StragglerDetector] = None,
    pipeline_overrides: Optional[Dict[str, Any]] = None,
    ckpt_overrides: Optional[Dict[str, Any]] = None,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """Train cfg for n_steps on the synthetic pipeline; returns final state+history.

    ``ckpt_every=None`` resolves the interval (and async-vs-blocking mode and
    retention) from the ``torch_train_checkpoint`` component for this
    state-size context; pass an int to pin it explicitly.  The parameters
    are drawn from a generator seeded with ``seed`` on ``device``, in the
    config's dtype."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_training on the card found no CUDA device; "
                           "pass device='cpu' to train on the CPU")
    hyper = hyper or TrainHyper()
    batcher = PrefetchingBatcher(
        PackedBatcher(SyntheticCorpus(cfg.vocab_size, seed=seed),
                      global_batch, seq_len),
        settings=pipeline_overrides)
    step_fn = train_step_for(cfg, hyper, microbatches=microbatches)

    state = init_train_state(cfg, torch.Generator(device=device).manual_seed(seed), device)
    start = 0
    ckpt = None
    blocking_save = False
    if ckpt_dir:
        cs = ckpt_settings.settings_for(ckpt_workload_signature(state_kb(state)))
        co = dict(ckpt_overrides or {})  # pinned values win, like serve's settings=
        if ckpt_every is None:
            ckpt_every = int(co.get("ckpt_every", cs["ckpt_every"]))
        blocking_save = str(co.get("mode", cs["mode"])) == "blocking"
        ckpt = AsyncCheckpointer(ckpt_dir,
                                 max_to_keep=int(co.get("max_to_keep", cs["max_to_keep"])))
        if latest_step(ckpt_dir) is not None:
            try:
                state, manifest = restore_checkpoint(ckpt_dir, state)
                start = int(manifest["step"]) + 1
            except FileNotFoundError:
                start = 0  # every checkpoint torn: cold start beats crashing
    elif ckpt_every is None:
        ckpt_every = 50

    tl = train_settings.settings_for(workload_signature(global_batch, seq_len, cfg.d_model))
    emitter = (TelemetryEmitter(get_component("torch_train_loop"), channel)
               if channel is not None else None)

    run = tracker.start_run(experiment) if tracker else None
    strag = straggler_detector or StragglerDetector(n_hosts=1)
    history = []
    last_saved: Optional[int] = None
    t_prev = time.perf_counter()
    for step in range(start, n_steps):
        if chaos is not None:
            chaos.on_step(step, ckpt_dir=ckpt_dir)
        batch = {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
                 for k, v in batcher.batch_at(step).items()}
        lr_scale = (float(lr_scale_source()) if lr_scale_source
                    else float(tl["lr_scale"]))
        state, metrics = step_fn(state, batch, lr_scale)
        metrics = {k: float(v) for k, v in metrics.items()}
        t_now = time.perf_counter()
        metrics["step_time_s"] = t_now - t_prev
        t_prev = t_now
        strag.record(0, step, metrics["step_time_s"])
        history.append(metrics)
        if emitter is not None:
            emitter.emit(metrics)
        if run:
            run.log_metrics(metrics, step=step)
        if on_step:
            on_step(step, metrics)
        if on_fault and (step + 1) % 8 == 0:
            for ev in strag.stragglers():
                on_fault(ev)
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step, state, blocking=blocking_save)
            last_saved = step
    # Save the final step only if this run trained past the last save: an
    # unconditional save would write a just-checkpointed step twice, and
    # clobber step n_steps-1 with a RESTORED state when a resume started at
    # or beyond n_steps.
    if ckpt and start < n_steps and last_saved != n_steps - 1:
        ckpt.save(n_steps - 1, state, blocking=True)
    if ckpt:
        ckpt.wait()
    batcher.close()
    if run:
        run.end()
    out = {"state": state, "history": history}
    if ckpt:
        out["ckpt_counters"] = dict(ckpt.counters)
    out["data_counters"] = dict(batcher.counters)
    return out
