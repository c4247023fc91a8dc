"""The reference's five examples as entry points of the port.

Each module is the twin of one file of the reference's ``examples/`` and
runs as ``python -m repro_torch.examples.<name>``, on the card unless
``--device cpu`` is given (a CUDA device that is not there raises; no
example falls back to the CPU):

  * :mod:`.quickstart` — the paper's Figure 1: an agent tunes ``lr_scale``
    of a live reduced OLMo-1B train job;
  * :mod:`.train_lm` — the training driver and its presets;
  * :mod:`.serve_decode` — the continuous server, and an agent that picks
    its admission size by measured tokens/s;
  * :mod:`.autotune_kernels` — the paper's Figure 2: a spawned agent
    process tunes the attention op over the shared-memory channel;
  * :mod:`.campaign_quickstart` — a hash-table campaign cold, resumed and
    warm-started.

Each ``main(argv)`` returns what it printed as a dict.  Outputs go under
the repository's ``results/torch/``.
"""
from __future__ import annotations

from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch"
