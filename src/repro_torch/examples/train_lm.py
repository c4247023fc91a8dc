"""End-to-end LM training driver.

The twin of the reference's ``examples/train_lm.py``:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset smoke            # on the card
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch mamba2-780m --preset smoke
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset smoke --device cpu

Presets (the reference's sizes; ``smoke`` is its ``cpu-smoke``):
  smoke  the arch's reduced config, 20 steps at 8 x 64           (seconds)
  100m   ~100M parameters in the arch's own family: 8 layers, d 512,
         300 steps at 16 x 512 (sized for a real accelerator)

Exercised: packed synthetic data, AdamW with warmup-cosine, async atomic
checkpointing with resume (re-run to resume; a run that finds its last
step checkpointed trains nothing), the straggler monitor, run tracking.
``--arch`` takes every config of the port; the reduced and 100m configs
are float32, as the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..bench import require_device
from ..configs import ALL_ARCHS, get_config
from ..core.tracking import Tracker
from ..models.config import ModelConfig
from ..runtime.steps import TrainHyper
from ..runtime.train_loop import run_training
from . import RESULTS

PRESETS = ("smoke", "100m")


def preset_config(arch: str, preset: str) -> Tuple[ModelConfig, Dict[str, int]]:
    cfg = get_config(arch)
    if preset == "smoke":
        return cfg.reduced().validate(), dict(n_steps=20, global_batch=8, seq_len=64)
    if preset == "100m":
        # ~100M params in the arch's own family
        cfg = dataclasses.replace(
            cfg.reduced(), n_layers=8, d_model=512,
            n_heads=8 if cfg.n_heads else 0, n_kv_heads=8 if cfg.n_heads else 0,
            head_dim=64 if cfg.n_heads else 0,
            d_ff=2048 if cfg.d_ff else 0, vocab_size=32768,
            moe_d_ff=1024 if cfg.is_moe else 0,
            moe_num_experts=8 if cfg.is_moe else 0,
            moe_top_k=2 if cfg.is_moe else 0,
            ssm_state=64 if cfg.ssm_state else 0, ssm_head_dim=64 if cfg.ssm_state else 64,
        ).validate()
        return cfg, dict(n_steps=300, global_batch=16, seq_len=512)
    raise ValueError(f"unknown preset {preset!r}: choose from {PRESETS}")


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="olmo-1b", choices=ALL_ARCHS)
    ap.add_argument("--preset", default="smoke", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=0, help="override the preset's step count")
    ap.add_argument("--ckpt-dir", default=str(RESULTS / "ckpt" / "train_lm"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    cfg, run_kw = preset_config(args.arch, args.preset)
    if args.steps:
        run_kw["n_steps"] = args.steps
    print(f"training {args.arch} [{args.preset}] on {device} — {cfg.param_count() / 1e6:.1f}M "
          f"params, {run_kw['n_steps']} steps × {run_kw['global_batch']}×{run_kw['seq_len']} "
          f"tokens")

    def on_step(step: int, m: Dict[str, float]) -> None:
        if step % 10 == 0 or step == run_kw["n_steps"] - 1:
            print(f"  step {step:4d}  loss {m['loss']:.4f}  |grad| {m['grad_norm']:.2f} "
                  f" lr {m['lr']:.2e}  {m['step_time_s'] * 1e3:.0f} ms")

    out = run_training(cfg, hyper=TrainHyper(base_lr=3e-3, warmup=20, total=run_kw["n_steps"]),
                       microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                       ckpt_every=50, tracker=Tracker(RESULTS / "runs"),
                       experiment="train_lm", on_step=on_step, device=device, **run_kw)
    hist = out["history"]
    if hist:
        print(f"done: loss {hist[0]['loss']:.3f} → {hist[-1]['loss']:.3f}; "
              f"checkpoints in {args.ckpt_dir} (re-run to resume)")
    else:
        print(f"nothing left to train: {args.ckpt_dir} holds step {run_kw['n_steps'] - 1}")
    return {"arch": args.arch, "preset": args.preset, "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist], "ckpt_dir": args.ckpt_dir,
            "params": cfg.param_count(), "device": str(device), **run_kw}


if __name__ == "__main__":
    main()
