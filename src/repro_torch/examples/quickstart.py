"""Quickstart: the MLOS loop around a PyTorch train job, end to end.

The twin of the reference's ``examples/quickstart.py``, the paper's Figure
1 with a train loop as the "system".  A reduced OLMo-1B trains for 30
steps (batch 8 x seq 64, the reference's schedule) while an MLOS agent
core, in this process, live-tunes the ``lr_scale`` auto-parameter of
``torch_train_loop`` (BO, Matérn-3/2) against the training loss: one
"experiment" is five steps at one scale, their mean loss the objective.
``lr_scale`` is an argument of every step, so a new value needs no
rebuild.  (:mod:`.autotune_kernels` shows the agent in its own process
over the shared-memory channel.)

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

from ..bench import require_device
from ..configs import get_config
from ..core.agent import AgentCore, make_session
from ..core.tracking import Tracker
from ..core.tunable import Float, TunableSpace
from ..runtime.steps import TrainHyper
from ..runtime.train_loop import run_training
from . import RESULTS

STEPS = 30
WINDOW = 5          # steps per experiment


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    cfg = get_config("olmo-1b").reduced().validate()
    print(f"model: {cfg.name} (reduced) — {cfg.param_count() / 1e6:.2f}M params, on {device}")
    # a session over the live-updatable lr_scale knob, the reference's range
    space = TunableSpace([Float("lr_scale", 1.0, 0.25, 4.0, log=True)])
    agent = AgentCore(make_session("torch_train_loop", "loss", space=space,
                                   optimizer="bo_matern32", budget=50))
    current = {"lr_scale": 1.0}
    window: List[float] = []
    tried: List[Dict[str, float]] = []

    def on_step(step: int, metrics: Dict[str, float]) -> None:
        window.append(metrics["loss"])
        if len(window) == WINDOW:
            avg = sum(window) / len(window)
            window.clear()
            tried.append({"lr_scale": current["lr_scale"], "avg_loss": avg})
            current.update(agent.observe_value(current, avg))
            print(f"  step {step:3d}  avg-loss {avg:.4f}  agent → "
                  f"lr_scale={current['lr_scale']:.3f}")

    out = run_training(cfg, n_steps=STEPS, global_batch=8, seq_len=64,
                       hyper=TrainHyper(base_lr=3e-3, warmup=5, total=200),
                       tracker=Tracker(RESULTS / "runs"), experiment="quickstart",
                       on_step=on_step, lr_scale_source=lambda: current["lr_scale"],
                       device=device)
    losses = [h["loss"] for h in out["history"]]
    print(f"loss: {losses[0]:.3f} → {losses[-1]:.3f} over {len(losses)} steps")
    print(f"best lr_scale found: {agent.best.config} (avg loss {agent.best.value:.4f})")
    return {"losses": losses, "tried": tried, "best_config": agent.best.config,
            "best_value": agent.best.value, "device": str(device)}


if __name__ == "__main__":
    main()
