"""The port's benchmarks: twins of the reference's
``benchmarks/serve_scenarios.py``, ``benchmarks/online_tuning.py``,
``benchmarks/kernel_autotune.py``, ``benchmarks/configstore_roundtrip.py``,
``benchmarks/fault_tolerance.py``, ``benchmarks/optimizer_throughput.py``,
``benchmarks/campaign_sweep.py``, ``benchmarks/multi_instance.py`` and
the cold/warm half of ``benchmarks/compile_cold_warm.py``, their runner
with its regression gate (:mod:`.runner`) and their smoke checks
(:mod:`.check`); the paper's Figures 3–5 (:mod:`.fig3_hashtable`,
:mod:`.fig4_counters`, :mod:`.fig5_spinlock`) and their suite
(:mod:`.run`).  Everything they write goes under :data:`BENCH_ROOT`, the
repository's ``results/torch/bench/``, never into the reference's
``results/bench/``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple, Union

import torch

BENCH_ROOT = Path(__file__).resolve().parents[3] / "results" / "torch" / "bench"


def require_device(device: Union[str, torch.device]) -> torch.device:
    """``device``, or a RuntimeError when it is CUDA and no card is there:
    a benchmark or an example never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a run on the card found no CUDA device; "
                           "pass device='cpu' to run it on the CPU")
    return device


def load_model(model: str, *, device: Union[str, torch.device],
               seed: int) -> Tuple[Dict[str, Any], Any]:
    """(params, cfg) of a served model with random weights from ``seed``: at
    its published widths in bf16 on the card, reduced in float32 on the
    CPU.  The width follows the device, so every record a benchmark files
    under the card is of the real model, and a CPU run stays a rehearsal of
    seconds.  A CUDA device that is not there raises: a benchmark never
    falls back to the CPU."""
    from ..configs import get_config
    from ..models import model as M

    device = require_device(device)
    cfg = get_config(model)
    cfg = cfg.reduced().validate() if device.type == "cpu" else cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    return M.init_params(cfg, gen, device=device), cfg
