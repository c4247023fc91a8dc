#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

  1. card          — the GPU's name and power limit (nvidia-smi); TF32 off
                     for float32 matmuls and convolutions.
  2. build         — compile every CUDA kernel of the serving and tuning
                     paths from ``src/repro_torch/csrc`` into
                     ``build/kernels/``, one ``nvcc`` per source, all at once;
                     print each library's nvcc wall time, registers, spills
                     and shared memory, and count the tensor-core
                     instructions in the SASS (``cuobjdump``) of every
                     instance of ``flash_attention_tc`` (``HGMMA``) and of
                     every ``ssd_tc`` pass that computes a product
                     (``HMMA``): none may have none.
  3. kernels       — each kernel against its plain PyTorch version on the
                     card, at the main paths' shapes and at edge shapes,
                     bf16 and float32: flash attention (every prefill
                     shape the serving phases give it: OLMo-1B's and
                     hymba-1.5b's widths, OLMo-1B's 4-row gang prefills,
                     reduced OLMo-1B's GQA 4->2 at head dim 16;
                     Mixtral-8x22B's and reduced Mixtral's windowed GQA
                     prefills, checked a block of 2048 query rows at a
                     time where wider; seamless-m4t-medium's non-causal
                     encoder (512 x 512), causal decoder and cross-attention
                     over 512 frames, llama-3.2-vision-11b's causal GQA
                     32->8 and cross-attention over 1601 modal tokens, at
                     every prompt width, the train-encdec shapes and the
                     reduced pair's; reduced OLMo-1B's shapes in the examples,
                     the cold/warm children and the training grid, and the
                     autotune example's B2 S512 H8 K4 D64 at every compiled
                     tile pair; each case carries its causal flag; GQA,
                     window, q_offset, non-pow2; the campaign grid's four shapes
                     at every tile pair compiled for the dtype; the
                     libraries' shared-memory tables against the
                     wrapper's), the SSD scan at both
                     compiled chunks, bf16 through ``ssd_tc`` and float32
                     through ``ssd`` (y and the final state; mamba2's and
                     hymba's prefill widths 2…1024, the grid's b2s512h48,
                     G = 2, non-pow2 S, the examples' reduced mamba2-780m) and RMSNorm (tests/test_kernels.py's
                     shapes, the served widths 1536 and 1600 at 8…16384
                     rows, with and without the residual, every compiled
                     instance at two ragged shapes and at the grid's two).
  4. serve         — full-width OLMo-1B (random bf16 weights from a seed)
                     served by the continuous ``BatchedServer`` on CUDA
                     graphs (its default on the card) over the seeded
                     heavy-tail mix with one prompt per pow2 prefill bucket
                     up to 1024; the kernels' launch counts are zeroed just
                     before and read just after, and must be (prefill
                     executions + prefill captures) x layers: a capture
                     records each wrapper's launch, a replay adds it back.  The same
                     requests then run one at a time (gang mode at batch 1,
                     the sequential reference), and the share of identical
                     token streams is reported with the top-2 logit gap at
                     each divergence.
  5. serve-ssm     — the same for full-width mamba2-780m (48 SSD layers):
                     every prefill runs the SSD kernel once per layer.
  6. serve-hybrid  — full-width hymba-1.5b, 8 requests at widths 2…1024:
                     every prefill runs flash attention and the SSD kernel
                     once per layer each.
  7. model         — reduced OLMo-1B, mamba2-780m and hymba-1.5b in float32
                     on the card (kernel path) vs the same weights on the
                     CPU (plain path), prefill at widths 24 and 2 plus 3
                     decode steps; then each served on the card: continuous
                     streams equal the one-at-a-time ones.
  7b. graphs       — each full-width model again with ``step="eager"`` and
                     ``step="graph"`` (the same step bodies on the same
                     static buffers, without and with capture): every
                     request's token stream must be identical; per path,
                     tokens/s, p50/p99, the decode step at batch 8 by CUDA
                     events, the host's wall and the device's busy time
                     and idle share, and the step registry's counters.
  8. timing        — each kernel, its plain version and the one PyTorch call
                     that computes the same function (none for SSD) on two
                     yardsticks: CUDA events over 20 eager calls, and the
                     tuner's device-held samples (``launch.microbench``,
                     the calls queued behind a device-side hold so the
                     card runs them back to back); beside the card's bound
                     for the work.  Flash attention at OLMo-1B's and
                     hymba-1.5b's widest prefill and the grid's four shapes;
                     the SSD scan (bf16) at mamba2-780m's and hymba-1.5b's
                     widest prefill and the grid's two shapes, and the
                     float32 FMA kernel at mamba2-780m's.
  9. profile       — the OLMo-1B and mamba2-780m serves again on a warm
                     server on CUDA graphs: tokens/s and p50, then under
                     torch.profiler (device activity only) the device's
                     busy share and top kernels.  (The eager profiles were
                     cut to keep the script inside its time.)
 10. campaign      — the MLOS loop on the card: the full ``kernels`` grid
                     (8 cells over the three kernels, bo, budget 6) through
                     ``repro_torch.launch.campaign`` into a temporary store
                     and journal; every cell done, every promoted entry
                     filed under this card, each kernel launched, a rerun
                     under the same id resumes with no measurement, and the
                     ops resolve and launch what was promoted.
 11. online        — the live server tuned on the card: full-width OLMo-1B
                     (the serve phase's bf16 weights), capacity 2048, at the
                     online benchmark's stale settings (``sync_interval``
                     16), serving the post-shift ``traffic.drifting`` slice
                     through the online benchmark's adapt phase
                     (``repro_torch.bench.online_tuning.adapt``: an
                     ``OnlineTuner``, ``rs``, 3 canaries x 4 window pairs;
                     with 3 the permutation test cannot reach its 0.1)
                     until a challenger promotes or the budget is spent;
                     every journal
                     transition, the promotions, rollbacks and what
                     ``config.resolve`` returns are printed.  Fails on a
                     malformed journal row, attention launches other than
                     prefills x 16, a host fetch outside the one per sync, a
                     resumed tuner that does not restore the champion and
                     the budget, or a resolve that misses a promotion.  Then
                     reduced OLMo-1B in float32 with the tuner in the loop
                     must give the one-at-a-time streams (near-ties aside).
 12. serve-bench   — ``repro_torch.bench.serve_scenarios`` at full-width
                     OLMo-1B, bf16, capacity 2048, heavy tail only: one
                     warm-up per scheduler over every width class of the
                     mix, then 5 timed replays per scheduler, records into
                     a temporary trajectory; medians of tokens/s, p50 and
                     p99, the continuous-vs-gang verdict (printed, not
                     gated; equal token totals gated), each replay's graph
                     captures and replays (a timed replay that captures
                     fails the phase: its servers take over the programs
                     the warm-ups captured) and the idle share of one more
                     continuous replay under the profiler.
 13. serving-grid  — the ``serving`` campaign grid on the card (reduced
                     OLMo-1B, bf16, bo budget 3) into a temporary store:
                     every cell done, every entry filed under this card, a
                     rerun under the same id measures nothing.
 13b. figures     — the paper's Figures 3-5 (``repro_torch.bench.fig3_hashtable``,
                     ``fig4_counters``, ``fig5_spinlock``) with fig3's and
                     fig5's BO arms on the torch GP engine on the card (the
                     objectives are host work: host µs, simulated ops/s);
                     gated on well-formed results (a trace of the budget's
                     length that never rises and a verdict for every
                     instance x optimizer, a row per table size whose
                     collisions never rise, a best spin per workload); the
                     claims C1-C6 printed, not gated; then the ``demo``
                     grid with every BO on the engine, gated as the
                     serving grid.
 13c. cold-warm   — ``repro_torch.bench.runner --quick --only
                     compile_cold_warm``: 6 fresh interpreters each building
                     the kernels of their first reduced OLMo-1B train step
                     into an empty root of their own, against 6 on a root
                     primed by one unmeasured child (all 13 start at once,
                     then step one at a time); ``check_compile_cold_warm``
                     (6 a side, ``improved``, a registry miss); every child
                     launched the attention kernel.  Started in the
                     background once the serving phases are released, read
                     after phase 30.
 13d. examples    — the five ``repro_torch.examples`` at their smoke sizes
                     on the card: quickstart (Figure 1, 30 steps), train_lm's
                     smoke preset on olmo-1b and mamba2-780m (launches =
                     steps x layers x 2), serve_decode (6 trials), autotune_kernels
                     (a spawned daemon: its report arrives, it exits 0) and
                     campaign_quickstart (the resume measures nothing, the
                     warm start beats the same cell cold).

 14. train        — full-width OLMo-1B (1.28 B params, random bf16 weights
                     from seed 0) trained by ``repro_torch.runtime.train_loop.
                     run_training`` on the port's synthetic corpus, batch 8 x
                     seq 2048: 6 steps with a checkpoint every 3 into a
                     temporary directory, then a second run to 8 steps that
                     must resume at step 6; the resumed steps' gradient
                     norms and losses in full beside the first run's state
                     stepped on to 8 in memory.  Per step: loss, gradient norm,
                     ms by CUDA events, tokens/s and an MFU reading (model
                     FLOPs over the step time over the bf16 peak); per run
                     the peak memory allocated and the checkpoint's blocked
                     seconds.  Fails on a non-finite loss, a resume that
                     does not continue, or flash-attention launches other
                     than steps x 16 layers x 2 (the layer recomputed under
                     ``remat`` "full").  Then one warm step again under
                     torch.profiler: busy time, idle share, top kernels.
 14b. training-grid — the ``training`` campaign grid in the train phase's
                     process (reduced OLMo-1B in bf16; the checkpoint policy
                     at kb2048, the pipeline at b4s128 and b8s256; bo budget
                     4), gated as the serving grid; it must launch the
                     attention kernel.
 15. train-ssm    — the same for full-width mamba2-780m at batch 4 x seq
                     1024, one step, a checkpoint, a resumed second step;
                     SSD launches steps x 48 x 2.
 16. train-grad   — at those shapes, bf16 and float32, outputs and input
                     gradients (q, k, v; x, dt, B, C) through each kernel's
                     autograd Function against autograd through its plain
                     version alone, within the kernels phase's tolerances.
                     Then whole-step gradients of full-width OLMo-1B (seed
                     0 weights, the corpus's first batch of 8 x 2048) cut
                     to 2 layers and whole, bf16 and float32: the kernel's
                     path against the plain path (attention
                     ``impl="naive"``) on the same weights and batch, on
                     the gradient norm and the worst leaf (the norm of its
                     difference over its norm): float32 within
                     ``STEP_GRAD_TOL`` at 2 layers, and whole within 4x the
                     move of the plain path with its attention outputs off
                     by the kernel's float32 error (the step is chaotic
                     there); bf16 against the float32 plain gradient,
                     within ``STEP_GRAD_TOL`` or 2x the bf16 plain path's
                     error; the largest leaves, the norm at cut depths and
                     over the first 8 batches.
 17. fault        — ``python -m repro_torch.bench.runner --only
                     fault_tolerance`` on the card (reduced OLMo-1B in bf16,
                     its children fresh interpreters on the card; the full
                     twin: 16 steps, 3 kills, 10 async/blocking pairs), then
                     ``check_fault_tolerance`` on its JSON: kill → resume
                     bit-identical, no re-measured campaign work, the torn
                     checkpoint's fallback, async beats blocking.  Started
                     in the background after 14b, read after 19.
 18. agent        — Figure 1: a spawned ``AgentProcess`` tunes
                     ``torch_train_loop.lr_scale`` (bo, budget 4, 2 steps a
                     config) of full-width OLMo-1B at batch 4 x seq 512 over
                     the shared-memory channel, applied through
                     ``AgentClient`` and ``lr_scale_source``; fails unless
                     every update lands, a session report arrives and the
                     daemon exits.
 19. optimizer    — the torch GP engine (``repro_torch.core.optimizers.
                     engine``, float64) on the card: the
                     ``optimizer_throughput`` twin at the reference's full
                     size (d 6, n 25/100/200, pool 1280, 8 sessions at
                     histories 25 and 100): ask ms numpy against torch,
                     tell and refit ms, sequential against batched ms, and
                     runs / captures / replays per program (suggest, append
                     and the batched suggest must be replays of programs
                     captured per shape class); suggestions at fixed hypers
                     identical on the card, the CPU and the numpy backend
                     (3 seeds x 3 asks), fitted θ within ``THETA_RTOL`` of
                     the CPU's, the batched ask of 8 equal to 8 sequential
                     asks.  Then the ``campaign_sweep`` twin at full size
                     with the numpy default and with every BO on the
                     engine (warm beats cold, every cell promoted under
                     this card); the ``kernels`` grid with
                     ``optimizer.backend=torch`` at bo budget 12 into a
                     temporary store (all 8 cells done and promoted, its
                     launches counted into the ``kernels`` line as
                     ``optimizer-grid``); and a spawned daemon with the
                     optimizer defaults ``{"backend": "torch", "device":
                     "cuda"}`` driving the ``multi_instance`` twin's 4
                     ``bo_torch`` sessions, whose bests must equal an
                     in-process drive of the same sessions.

 20. serve-moe     — full-width, full-depth OLMoE-1B-7B (16 layers, d 2048,
                     64 experts, top-8, QK-norm; 6.92 B params, bf16)
                     served as in the serve phase (capacity 2048, max_batch
                     8, 16 requests at widths 2…1024, CUDA graphs):
                     tokens/s, p50/p99, launches (prefill executions +
                     captures) x 16; the one-at-a-time streams are printed
                     beside the continuous ones, not gated (expert capacity
                     couples the rows of a batch).
 21. serve-moe-window — Mixtral-8x22B at full width (d 6144, GQA 48->8, 8
                     experts, top-2, ff 16384, window 4096) cut to 4 of 56
                     layers, capacity 16384 (the server keeps capacity // 2
                     prompt tokens: a prompt of 4097…8192 tokens prefills at
                     width 8192, past the window, and its ring buffer
                     wraps), max_batch 8, prompts at widths 2, 64, 1024 and
                     8192.
 22. graphs-moe   — both MoE models with ``step="eager"`` and ``"graph"``:
                     identical streams required; decode step ms by events,
                     host wall, busy ms, idle share and the graphed step's
                     costliest kernels (printed for every graphs phase).
 23. model-moe    — reduced OLMoE-1B-7B and Mixtral-8x22B in float32: card
                     (kernel path) vs CPU (plain path) logits as in the
                     model phase, then served on the card eagerly and on
                     graphs: identical streams required.
 24. moe-dispatch — ``apply_moe`` of OLMoE's first layer at its decode (T 8),
                     prefill (T 1024) and train (T 8192) token counts, per
                     strategy (gather, local_tp, dense, auto): ms by events
                     and device-held, beside the bound of the work; the
                     ``dropped_frac`` at capacity factors 1.0, 1.25 and 2.0;
                     the capacity path against the dense oracle where
                     nothing drops; the costliest kernels of ``gather`` and
                     ``dense``.
 25. train-moe    — full-width OLMoE-1B-7B cut to 2 layers, batch 4 x seq
                     2048, 3 steps from the seed's state, twice: finite
                     losses, every loss, gradient norm and state leaf the
                     same bits in both runs; ms by events, tokens/s, MFU
                     reading (active parameters), peak memory; then reduced
                     OLMoE-1B-7B trained by ``run_training`` with a
                     checkpoint and a second run that resumes at the saved
                     step.
 26. serve-encdec — seamless-m4t-medium at full size (12 encoder and 12
                     decoder layers, d 1024, H16 D64, 0.878 B params, bf16)
                     served as in the serve phase at capacity 2048 (the
                     stub's 512 zero frames a request: the encoder's
                     non-causal 512 x 512 prefill, the decoder's causal
                     self-attention and its cross-attention over 512
                     frames), max_batch 8, CUDA graphs; launches (prefill
                     executions + captures) x (12 + 2 x 12).  The
                     one-at-a-time replay is not run (27 gates the streams).
 27. serve-vlm    — llama-3.2-vision-11b at full size (40 layers + 8 cross
                     blocks, d 4096, GQA 32->8, 10.11 B params, bf16), the
                     same settings, 1601 zero modal tokens a request;
                     launches x (40 + 8).
 28. graphs-xattn — each of the two again eager and graphed: identical
                     streams required; decode step ms by events, host wall,
                     busy ms, idle share, the costliest kernels.
 29. model-xattn  — reduced seamless and the VLM reduced to two groups in
                     float32 with seeded non-zero modal frames (the serve
                     stub's zeros leave a VLM's cross-attention at 0):
                     forward, prefill at widths 24 and 2 and 3 decode steps,
                     card (kernel path) against CPU (plain path) within
                     1e-4.
 30. train-encdec — seamless-m4t-medium at full size, batch 4 x seq 1024
                     with 1024 seeded frames a row, 3 steps from the seed's
                     state twice: the same bits in both runs (the encoder's
                     and the cross-attention's gradients through the kernel
                     Function's plain backward); ms by events, MFU reading,
                     peak memory.

Phases 11-13b and 13d run after the campaign phase, before the profiles;
phases 20-24 and 26-29 after the profiles, once the serving phases'
servers, weights and graph pools are released (one model's weights at a
time), then 25 and 30; phases 14-19 after those, once theirs are released
too.  Two twins whose children are fresh interpreters run in the
background, each in a process group of its own that the script kills if it
fails: 13c beside 20-30, 17 beside 15-19 (the train phase and its profile
run alone).  A
server hands its graphs and buffers over to the next server of its params
and context (``repro_torch.core.compilecache``): every release point drops
what is still handed over.  The script
sets ``CUBLAS_WORKSPACE_CONFIG`` before its first product.  Each phase
from 11 on prints its wall time; after each phase the script prints the
memory the caching allocator reserved (``torch.cuda.max_memory_reserved``)
and the time since the start, and it prints its total before the last two
lines of standard output: the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  The port imports no jax and nothing of
the reference package, and neither does this script.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak, FLOP/s
PEAK_BYTES = 3.35e12         # H100 SXM HBM3, bytes/s
TOL = {torch.bfloat16: 5.0 * 2.0 ** -8,                      # inputs rounded, f32 accumulation
       torch.float32: 170.0 * float(np.finfo(np.float32).eps)}  # rounding inside the reductions
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores, FLOP/s
SSD_HEADROOM = 4.0           # tests/test_kernels.py: the scan's chunk hand-offs
SSD_STATE_TOL = 1e-3         # float32 final state, absolute and relative
SEED = 17
# serve-moe-window: Mixtral-8x22B's prompt widths, capacity and cut depth.
# The server keeps capacity // 2 prompt tokens, so capacity 16384 lets a
# prompt past the 4096-token window prefill at width 8192.
MOE_WINDOW_WIDTHS = [2, 64, 1024, 8192]
MOE_WINDOW_CAPACITY = 16384
MOE_WINDOW_LAYERS = 4
# (batch, seq_q, seq_k, heads, kv_heads, head_dim, window, q_offset, causal)
SERVE_WIDTHS = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
XATTN_CAPACITY = 2048        # serve-encdec / serve-vlm: the encdec source is capacity // 4 = 512
XATTN_MODAL = {"seamless-m4t-medium": 512, "llama-3.2-vision-11b": 1601}
XATTN_REDUCED_MODAL = 12     # model-xattn: reduced seamless' frames (the VLM's: its own 8)
XATTN_TRAIN = (4, 1024)      # train-encdec: batch x seq, and as many frames
ATTN_CASES = [
    # OLMo-1B prefill shapes: every pow2 prompt width the server can give
    *((1, w, w, 16, 16, 128, 0, 0, True) for w in SERVE_WIDTHS),
    # hymba-1.5b prefill shapes: GQA 25->5, head_dim 64, window 2048 (wider than any prompt)
    *((1, w, w, 25, 5, 64, 2048, 0, True) for w in SERVE_WIDTHS),
    # OLMo-1B gang prefills (serve-bench): max_batch 4 rows at every pow2 heavy-tail width
    *((4, w, w, 16, 16, 128, 0, 0, True) for w in (2, 4, 8, 16, 32, 64)),
    # reduced OLMo-1B prefills (serving grid, f32 parity phases): GQA 4->2, head_dim 16
    *((1, w, w, 4, 2, 16, 0, 0, True) for w in (2, 4, 8, 16, 32)),
    # (OLMoE-1B-7B's prefills are OLMo-1B's shapes: H16 K16 D128, QK-normed q and k)
    # Mixtral-8x22B prefills (serve-moe-window): GQA 48->8, window 4096
    *((1, w, w, 48, 8, 128, 4096, 0, True) for w in MOE_WINDOW_WIDTHS),
    # reduced Mixtral-8x22B prefills (model-moe): GQA 4->2, head_dim 16, window 16
    *((1, w, w, 4, 2, 16, 16, 0, True) for w in (2, 4, 8, 16, 32)),
    # seamless-m4t-medium (serve-encdec): the encoder's non-causal 512 x 512 over the
    # modal frames, the decoder's causal self-attention and its cross-attention over
    # the 512 encoded frames at every prompt width; H16 K16 D64
    (1, 512, 512, 16, 16, 64, 0, 0, False),
    *((1, w, w, 16, 16, 64, 0, 0, True) for w in SERVE_WIDTHS),
    *((1, w, 512, 16, 16, 64, 0, 0, False) for w in SERVE_WIDTHS),
    # llama-3.2-vision-11b (serve-vlm): causal GQA 32->8 D128, and cross-attention
    # over the 1601 modal tokens (no tile divides them) at every prompt width
    *((1, w, w, 32, 8, 128, 0, 0, True) for w in SERVE_WIDTHS),
    *((1, w, 1601, 32, 8, 128, 0, 0, False) for w in SERVE_WIDTHS),
    # train-encdec: seamless at 4 x 1024 with 1024 frames (encoder, decoder, cross)
    (4, 1024, 1024, 16, 16, 64, 0, 0, False),
    (4, 1024, 1024, 16, 16, 64, 0, 0, True),
    # reduced seamless and llama-vision (model-xattn, f32, batch 2, widths 24 and 2): GQA
    # 4->2 D16; seamless' 12 frames through the encoder, both models' cross-attention
    (2, XATTN_REDUCED_MODAL, XATTN_REDUCED_MODAL, 4, 2, 16, 0, 0, False),
    *((2, w, w, 4, 2, 16, 0, 0, True) for w in (24, 2)),
    *((2, w, m, 4, 2, 16, 0, 0, False) for w in (24, 2) for m in (XATTN_REDUCED_MODAL, 8)),
    # reduced OLMo-1B in float32 (GQA 4->2, head dim 16) trained by the examples phase
    # (quickstart and train_lm's smoke preset at 8 x 64) and by the cold/warm
    # twin's children (4 x 64); in bf16 by the training grid (2 x 32)
    (8, 64, 64, 4, 2, 16, 0, 0, True),
    (4, 64, 64, 4, 2, 16, 0, 0, True),
    (2, 32, 32, 4, 2, 16, 0, 0, True),
    (2, 256, 256, 32, 8, 128, 0, 0, True),      # GQA
    (1, 300, 300, 16, 16, 128, 48, 0, True),    # sliding window
    (1, 100, 228, 8, 8, 64, 0, 128, True),      # q_offset > 0 (chunked prefill)
    (2, 77, 77, 4, 2, 32, 0, 0, True),          # non-pow2, ragged tiles
    (1, 40, 40, 4, 4, 16, 0, 0, True),
    (2, 200, 300, 8, 4, 64, 0, 0, False),       # non-causal, Sq != Sk
]
# The `kernels` campaign grid's attention shapes (OLMo-1B heads, causal):
# every (block_q, block_kv) pair compiled for the dtype, which the grid
# times and may promote
ATTN_GRID_CASES = [(b, s, s, 16, 16, 128, 0, 0, True) for b, s in ((1, 128), (2, 256),
                                                                 (2, 512), (4, 1024))]
# The examples phase's autotune_kernels shape (B2 S512 H8 K4 D64, float32 in
# the example), which the agent times at every tile pair it proposes
ATTN_AUTOTUNE_CASES = [(2, 512, 512, 8, 4, 64, 0, 0, True)]
# (batch, seq, heads, head_dim, state, groups)
# RMSNorm shapes (..., d): tests/test_kernels.py's spot checks and RMS_GRID,
# then the served norm widths (mamba2-780m 1536, hymba-1.5b 1600)
RMS_CASES = [(8, 128), (2, 16, 256), (3, 96), (6, 160), (2, 5, 48), (7, 1024),
             *((rows, d) for d in (1536, 1600) for rows in (8, 1024, 16384))]
RMS_RAGGED = [(37, 1536), (11, 100)]     # every compiled instance: a ragged last block; scalar path
RMS_GRID_CASES = [(2048, 1536), (16384, 1536)]   # every instance at the campaign grid's shapes
SSD_CASES = [
    # mamba2-780m and hymba-1.5b prefill shapes: every pow2 prompt width
    *((1, w, 48, 64, 128, 1) for w in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)),
    *((1, w, 25, 128, 16, 1) for w in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)),
    (2, 256, 8, 64, 128, 2),             # G = 2 grouping, batch 2
    (2, 512, 48, 64, 128, 1),            # the campaign grid's b2s512h48
    (1, 300, 48, 64, 128, 1),            # non-pow2 S: a ragged last chunk
    (3, 77, 4, 16, 16, 1),               # P 16, ragged
    (8, 64, 8, 16, 16, 1),               # reduced mamba2-780m, train_lm's smoke preset (examples)
]


def _import_port():
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import kernel, ref
    return kernel, ref


def _kernels():
    """The wrappers whose ``launches`` count the main paths' kernel launches."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.ssd import kernel as ssd
    return {"flash_attention": fa.flash_attention, "ssd": ssd.ssd, "rmsnorm": rms.rmsnorm}


def attention_passes(cfg) -> int:
    """Full-sequence attention calls of one forward pass or prefill: one a
    layer (dense, moe, hybrid); an encoder-decoder's encoder layers plus
    its decoder layers twice (self and cross); a VLM's layers plus one cross
    block a group."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    if cfg.family == "vlm":
        return cfg.n_layers + cfg.n_layers // cfg.cross_attn_period
    return cfg.n_layers if cfg.family in ("dense", "moe", "hybrid") else 0


def _expected_launches(cfg, prefills: int) -> dict:
    """Per prefill, one launch of each kernel the family runs per call site
    (:func:`attention_passes`; one SSD scan a layer for ssm and hybrid; the
    models normalize inline: RMSNorm's kernel is on the tuning path only)."""
    return {"flash_attention": prefills * attention_passes(cfg),
            "ssd": prefills * cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0,
            "rmsnorm": 0}


# --------------------------------------------------------------------- card
def phase_card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {line}")
    print("card: torch.backends.cuda.matmul.allow_tf32=False, torch.backends.cudnn.allow_tf32=False")
    print(f"card: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return line


# -------------------------------------------------------------------- build
FA_TC = "flash_attention_tc"
SSD_TC = "ssd_tc"
SSD_TC_PRODUCTS = ("ssd_tc_states_kernel", "ssd_tc_scan_kernel")   # the passes with a product
CUDA_SOURCES = ["flash_attention", FA_TC, "ssd", SSD_TC, "rmsnorm"]


def _ptxas_report(log: str) -> list:
    """(function, registers, spill bytes) per kernel of an ``-Xptxas -v`` log."""
    out, fn, spill = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and fn:
            out.append((fn, int(line.split("Used")[1].split("registers")[0]), spill))
            fn = None
    return out


def _tool(name: str) -> Optional[str]:
    """A CUDA binary tool: on PATH, in the toolkit, or in triton's package."""
    import importlib.util
    import shutil

    found = [shutil.which(name), f"/usr/local/cuda/bin/{name}"]
    triton = importlib.util.find_spec("triton")
    if triton is not None and triton.origin:
        found.append(Path(triton.origin).parent / "backends" / "nvidia" / "bin" / name)
    return next((str(c) for c in found if c and Path(c).exists()), None)


def _sass_counts(lib: Path, opcode: str) -> dict:
    """Function → (number of ``opcode`` instructions, number of instructions)
    in the library's SASS."""
    dump = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None and line.strip().startswith("/*") and line.count("*/") >= 2:
            counts[fn][0] += line.count(opcode)
            counts[fn][1] += 1
    return {fn: tuple(c) for fn, c in counts.items()}


def phase_build() -> dict:
    """Build every source at once; report each library and prove that the
    bf16 attention kernel's products run on the tensor cores."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel

    t0 = time.perf_counter()
    libs = build.build(CUDA_SOURCES)
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    info = {}
    for name, path in libs.items():
        log = path.with_name(path.name + ".log").read_text()
        wall = [ln.split()[2] for ln in log.splitlines() if ln.startswith("nvcc wall")]
        report = _ptxas_report(log)
        regs = [r for _, r, _ in report]
        spills = [sp for _, _, sp in report]
        static = [int(n) for n in re.findall(r"(\d+) bytes smem", log)]
        info[name] = {"nvcc_s": float(wall[-1]) if wall else None, "kernels": len(report),
                      "registers": [min(regs), max(regs)] if regs else None,
                      "max_spill_bytes": max(spills) if spills else None}
        print(f"build: {name}: nvcc {wall[-1] if wall else '(cached)'} s, {len(report)} kernels, "
              f"registers {info[name]['registers']}, spill stores up to "
              f"{info[name]['max_spill_bytes']} bytes, static shared memory up to "
              f"{max(static, default=0)} bytes (dynamic: below for attention)")
    for dtype, source in kernel.SOURCES.items():
        table = [(bq, bk, d, kernel.smem_bytes(dtype, bq, bk, d)) for bq in kernel.TILES
                 for bk in kernel.TILES for d in kernel.HEAD_DIMS
                 if kernel.compiled(dtype, bq, bk, d)]
        print(f"build: {source} ({dtype}): {len(table)} instances, dynamic shared memory "
              f"{min(t[3] for t in table)}-{max(t[3] for t in table)} bytes")
    if _tool("cuobjdump") is None:
        raise AssertionError("cuobjdump not found: the tensor-core check cannot run")
    sass = _sass_counts(libs[FA_TC], "HGMMA")
    regs = {fn: r for fn, r, _ in _ptxas_report(libs[FA_TC].with_name(
        libs[FA_TC].name + ".log").read_text())}
    for fn, (n, size) in sass.items():
        tiles = "/".join(re.findall(r"Li(\d+)E", fn)) or fn     # <BQ, BKV, D> of the mangled name
        print(f"build: {FA_TC} <{tiles}> SASS: {n:3d} HGMMA of {size} instructions, "
              f"{regs.get(fn, '?')} registers at entry")
    hgmma = [n for n, _ in sass.values()]
    if not hgmma or min(hgmma) == 0:
        raise AssertionError(f"a bf16 attention instance has no HGMMA in its SASS: {sass}")
    info[FA_TC]["hgmma_per_instance"] = [min(hgmma), max(hgmma)]
    info[FA_TC]["sass_instructions"] = [min(c for _, c in sass.values()),
                                        max(c for _, c in sass.values())]

    sass = _sass_counts(libs[SSD_TC], "HMMA")
    report = {fn: (r, sp) for fn, r, sp in _ptxas_report(libs[SSD_TC].with_name(
        libs[SSD_TC].name + ".log").read_text())}
    products = {fn: c for fn, c in sass.items() if any(k in fn for k in SSD_TC_PRODUCTS)}
    for fn, (n, size) in sass.items():
        name = next((k for k in (*SSD_TC_PRODUCTS, "ssd_tc_pass_kernel") if k in fn), fn)
        inst = "/".join(re.findall(r"Li(\d+)E", fn))               # <Q, N[, P]> of the mangled name
        regs, spill = report.get(fn, ("?", "?"))
        print(f"build: {SSD_TC} {name}" + (f" <{inst}>" if inst else "") + f" SASS: {n:3d} HMMA "
              f"of {size} instructions, {regs} registers, {spill} bytes spilled")
    hmma = [n for n, _ in products.values()]
    # a chunk-state instance per (chunk, state dim), a scan instance per (chunk, state dim, P)
    want = len(ssd_kernel.CHUNKS) * len(ssd_kernel.STATE_DIMS) * (1 + len(ssd_kernel.TC_HEAD_DIMS))
    if len(products) != want or min(hmma) == 0:
        raise AssertionError(f"an ssd_tc product instance has no HMMA in its SASS (or one of "
                             f"the {want} is missing): {products}")
    info[SSD_TC]["hmma_per_instance"] = [min(hmma), max(hmma)]
    info[SSD_TC]["sass_instructions"] = [min(c for _, c in sass.values()),
                                         max(c for _, c in sass.values())]
    return info


# ------------------------------------------------------------------ kernels
def _qkv(case, dtype, device, seed):
    b, sq, sk, h, kh, d = case[:6]
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device).to(dtype)
    return mk(b, sq, h, d), mk(b, sk, kh, d), mk(b, sk, kh, d)


def _plain_attention(ref, q, k, v, window: int, q_offset: int, causal: bool = True,
                     rows: int = 2048):
    """``naive_attention``, a block of ``rows`` query rows at a time (a row's
    output depends on its own scores only): at once, the float32 scores of
    an 8192-token prefill at 48 heads would take 13 GB."""
    outs = [ref.naive_attention(q[:, r0:r0 + rows], k, v, causal=causal, window=window,
                                q_offset=q_offset + r0) for r0 in range(0, q.shape[1], rows)]
    return torch.cat(outs, dim=1)


def phase_kernels(device) -> dict:
    """Kernel vs plain on the card: the edge and serve shapes at the default
    tiles, the campaign grid's shapes at every tile pair compiled for the
    dtype; the libraries' shared-memory tables against the wrapper's.
    Returns the max abs error per dtype."""
    kernel, ref = _import_port()
    for dtype, source in kernel.SOURCES.items():
        for bq in kernel.TILES:
            for bk in kernel.TILES:
                for d in kernel.HEAD_DIMS:
                    want = kernel.smem_bytes(dtype, bq, bk, d)
                    want = want if kernel.compiled(dtype, bq, bk, d) else -1
                    got = kernel.library_smem_bytes(dtype, bq, bk, d)
                    if got != want:
                        raise AssertionError(f"{source} {bq}/{bk} d{d}: the library gives "
                                             f"{got} bytes, the wrapper {want}")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        pairs = [(bq, bk) for bq in kernel.TILES for bk in kernel.TILES
                 if kernel.compiled(dtype, bq, bk, 128)]
        cases = [(case, 64, 64) for case in ATTN_CASES] + [
            (case, bq, bk) for case in ATTN_GRID_CASES + ATTN_AUTOTUNE_CASES
            for bq in kernel.TILES for bk in kernel.TILES
            if kernel.compiled(dtype, bq, bk, case[5])]
        worst = 0.0
        for i, (case, bq, bk) in enumerate(cases):
            q, k, v = _qkv(case, dtype, device, seed=1000 + i)
            window, q_offset, causal = case[6:]
            got = kernel.flash_attention(q, k, v, causal=causal, window=window,
                                         q_offset=q_offset, block_q=bq, block_kv=bk)
            want = _plain_attention(ref, q, k, v, window, q_offset, causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            tol = TOL[dtype]
            bad = err > tol + tol * want.float().abs()
            if not torch.isfinite(got).all() or bad.any():
                raise AssertionError(f"kernel (tiles {bq}/{bk}) disagrees with naive_attention at "
                                     f"{case} {dtype}: max abs err {err.max().item():.3g}, "
                                     f"tol {tol:.3g}")
            worst = max(worst, err.max().item())
        errs[str(dtype).replace("torch.", "")] = worst
        print(f"kernels: flash_attention ({kernel.SOURCES[dtype]}) vs naive_attention, {dtype}: "
              f"{len(ATTN_CASES)} cases at tiles 64/64 + {len(ATTN_GRID_CASES)} grid shapes x "
              f"tile pairs {pairs} + the autotune example's shape at every compiled tile "
              f"pair, max abs err {worst:.3g} (tol {TOL[dtype]:.3g} abs + rel)")
    return errs


def _ssd_inputs(case, dtype, device, seed):
    """x, dt (softplus'd), A (< 0), B, C, D; B and C of variance N^-1/2, so
    C·B has unit variance as after the model's projections (unit B, C at
    N = 128 make terms of y ~10² that cancel beyond any f32 tolerance)."""
    b, s, h, p, n, g = case
    gen = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=gen, device=device)
    x, B, C = mk(b, s, h, p).to(dtype), (mk(b, s, g, n) / n ** 0.25).to(dtype), \
        (mk(b, s, g, n) / n ** 0.25).to(dtype)
    dt = torch.nn.functional.softplus(mk(b, s, h))
    A = -torch.exp(0.5 * mk(h))
    D = 1.0 + 0.1 * mk(h)
    return x, dt, A, B, C, D


def phase_kernels_ssd(device) -> dict:
    """SSD kernel vs the plain ``ssd_chunked`` on the card, y and the final
    state, at every compiled chunk; returns the max abs errors of y per
    dtype and of the state."""
    from repro_torch.kernels.ssd import kernel, ref

    errs, state_worst = {}, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        tol = TOL[dtype] * SSD_HEADROOM
        for i, case in enumerate(SSD_CASES):
            t = _ssd_inputs(case, dtype, device, seed=2000 + i)
            wy, ws = ref.ssd_chunked(*t, chunk=ref.align_chunk(64, case[1]), return_state=True)
            for chunk in kernel.CHUNKS:
                y, st = kernel.ssd(*t, chunk=chunk, return_state=True)
                torch.cuda.synchronize()
                err = (y.float() - wy.float()).abs()
                serr = (st - ws).abs()
                if (not torch.isfinite(y).all() or not torch.isfinite(st).all()
                        or (err > tol + tol * wy.float().abs()).any()
                        or (serr > SSD_STATE_TOL + SSD_STATE_TOL * ws.abs()).any()):
                    raise AssertionError(
                        f"ssd kernel (chunk {chunk}) disagrees with ssd_chunked at {case} "
                        f"{dtype}: max abs err y {err.max().item():.3g} (tol {tol:.3g}), "
                        f"state {serr.max().item():.3g} (tol {SSD_STATE_TOL})")
                worst = max(worst, err.max().item())
                state_worst = max(state_worst, serr.max().item())
        errs[str(dtype).replace("torch.", "")] = worst
        print(f"kernels: ssd ({kernel.SOURCES[dtype]}) vs ssd_chunked, {dtype}: "
              f"{len(SSD_CASES)} cases x chunks {kernel.CHUNKS}, max abs err y {worst:.3g} "
              f"(tol {tol:.3g} abs + rel)")
    print(f"kernels: ssd final state (f32), max abs err {state_worst:.3g} "
          f"(tol {SSD_STATE_TOL} abs + rel)")
    return {"y": errs, "state": state_worst}


def _rms_inputs(shape, dtype, device, seed, residual=True):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device).to(dtype)
    r = torch.randn(shape, generator=gen, device=device).to(dtype) if residual else None
    return x, r, torch.linspace(0.5, 1.5, shape[-1], device=device)


def _rms_check(got, want, dtype, what) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    if got.dtype != want.dtype or not torch.isfinite(got).all() or \
            (err > tol + tol * want.float().abs()).any():
        raise AssertionError(f"rmsnorm kernel disagrees with ref.rmsnorm at {what}: max abs err "
                             f"{err.max().item():.3g}, tol {tol:.3g}")
    return err.max().item()


def phase_kernels_rmsnorm(device) -> dict:
    """RMSNorm kernel vs the plain ``ref.rmsnorm`` on the card; returns the
    max abs error per dtype."""
    from repro_torch.kernels.rmsnorm import kernel, ref

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst, n = 0.0, 0
        for i, shape in enumerate(RMS_CASES):
            for residual in (False, True):
                x, r, scale = _rms_inputs(shape, dtype, device, 3000 + i, residual)
                worst = max(worst, _rms_check(kernel.rmsnorm(x, scale, r), ref.rmsnorm(x, scale, r),
                                              dtype, f"{shape} {dtype} residual={residual}"))
                n += 1
        # ragged shapes with the residual; the grid's shapes without, as it runs
        instance_cases = [(s, True) for s in RMS_RAGGED] + [(s, False) for s in RMS_GRID_CASES]
        for i, (shape, residual) in enumerate(instance_cases):
            x, r, scale = _rms_inputs(shape, dtype, device, 3100 + i, residual)
            want = ref.rmsnorm(x, scale, r)
            for rows in kernel.BLOCK_ROWS:
                for threads in kernel.ROW_THREADS:
                    got = kernel.rmsnorm(x, scale, r, block_rows=rows, row_threads=threads)
                    worst = max(worst, _rms_check(got, want, dtype, f"{shape} {dtype} "
                                                  f"residual={residual} block_rows {rows} "
                                                  f"row_threads {threads}"))
                    n += 1
        errs[str(dtype).replace("torch.", "")] = worst
        print(f"kernels: rmsnorm vs ref.rmsnorm, {dtype}: {n} cases (every block_rows x "
              f"row_threads instance at {RMS_RAGGED + RMS_GRID_CASES}), max abs err {worst:.3g} "
              f"(tol {TOL[dtype]:.3g} abs + rel)")
    return errs


# -------------------------------------------------------------------- serve
def _streams(server) -> dict:
    return {r.rid: list(r.tokens) for r in server.results.values()}


def _top2_gap(params, cfg, prompt, width, stream, capacity, device) -> float:
    """Replay one request alone (batch 1), feeding ``stream``; the top-2
    logit gap after the last token says how near a tie the next argmax was."""
    from repro_torch.models import model as M

    toks = np.zeros((1, width), np.int64)
    n = min(len(prompt), width)
    toks[0, -n:] = prompt[-n:]
    logits, caches, pos = M.prefill(params, cfg, torch.from_numpy(toks).to(device), capacity)
    for t in stream:
        logits, caches = M.decode_step(params, cfg, torch.tensor([t], device=device), caches, pos)
        pos += 1
    top = logits[0].topk(2).values
    return (top[0] - top[1]).item()


def smoke_arrivals(seed: int, n: int, vocab: int, max_width: int, long_max: int,
                   widths: Optional[list] = None) -> list:
    """The reference ``heavy_tail`` mix (arrival times, budgets, prompts)
    with the first requests' prompts redrawn, one per pow2 prefill bucket
    (``widths``: by default every bucket from 2 to ``max_width``), each a
    length inside its bucket, so most are left-padded.  The mix's own
    prompts (median 8, at most 64) never reach the wide buckets; this covers
    every width the kernels serve.  It is a smoke run's coverage, not a
    sourced traffic mix."""
    from repro_torch.runtime import traffic

    widths = widths or [2 ** k for k in range(1, max_width.bit_length())]
    if len(widths) > n:
        raise ValueError(f"{n} requests cannot cover the {len(widths)} buckets up to {max_width}")
    rng = np.random.default_rng(seed)
    arrivals = traffic.heavy_tail(seed, n=n, long_max=long_max, vocab=vocab)
    for i, w in enumerate(widths):
        n_prompt = int(rng.integers(w // 2 + 1, w + 1))
        prompt = rng.integers(2, vocab, size=max(2, n_prompt)).astype(np.int32)
        arrivals[i] = dataclasses.replace(arrivals[i], prompt=prompt)
    return arrivals


class _FetchCounter:
    """Stands in for ``serve_loop._host_fetch``: counts the fetches and the
    decode steps each one carries (a continuous sync fetches one row per
    step)."""

    def __init__(self):
        from repro_torch.runtime import serve_loop

        self.module, self.real, self.rows = serve_loop, serve_loop._host_fetch, []

    def __call__(self, x):
        self.rows.append(int(x.shape[0]))
        return self.real(x)

    def __enter__(self):
        self.module._host_fetch = self
        return self

    def __exit__(self, *exc):
        self.module._host_fetch = self.real


def _divergences(srv, params, cfg, arrivals, capacity: int, device) -> list:
    """The same requests one at a time (gang mode at batch 1, each at its
    own prompt width: a wider gang batch pads every member to its widest),
    against ``srv``'s streams: the first differing step of each request
    that differs, with the top-2 logit gap there."""
    from repro_torch.runtime import serve_loop, traffic

    gang = serve_loop.BatchedServer(params, cfg, capacity=capacity, eos_id=-1, mode="gang",
                                    settings={"max_batch": 1}, device=device)
    traffic.replay(gang, arrivals)
    cont_s, gang_s = _streams(srv), _streams(gang)
    out = []
    for rid, a in enumerate(arrivals):
        s_c, s_g = cont_s[rid], gang_s[rid]
        if s_c == s_g:
            continue
        t = next(i for i, (x, y) in enumerate(zip(s_c, s_g)) if x != y)
        gap = _top2_gap(params, cfg, a.prompt, srv._width_of(len(a.prompt)), s_c[:t],
                        capacity, device)
        out.append({"rid": rid, "step": t, "top2_gap": gap})
    return out


def _prefill_terms(srv) -> tuple:
    """(prefill executions, prefill captures) of a server: each adds one
    launch per attention layer of every kernel its family runs (a capture
    records the wrappers' launches, a replay adds them back).  Captures are
    the server's own: the programs it took over from an earlier server of
    its model and context were captured there."""
    return srv.prefill_calls, srv.prefill_captures


def serve_main_path(device, cfg, *, capacity: int, max_batch: int, n_requests: int,
                    max_width: int, seed: int = SEED, long_max: int = 64,
                    init_seed: int = 0, widths: Optional[list] = None,
                    step: Optional[str] = None, params=None, divergences: bool = True) -> dict:
    """Serve the smoke mix through the continuous server (``step``: the
    server's default, CUDA graphs on the card), then the same requests one
    at a time (gang mode, batch 1).  Returns counts, metrics and the
    divergences; raises if a request overran its budget, a sync went
    missing or a prefill bypassed a kernel of its family."""
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop, traffic

    from repro_torch.core import compilecache

    device = torch.device(device)
    kernels = _kernels()
    if params is None:
        gen = torch.Generator(device=device).manual_seed(init_seed)
        params = M.init_params(cfg, gen, device=device)
    arrivals = smoke_arrivals(seed, n_requests, cfg.vocab_size, max_width, long_max, widths)
    registry0 = compilecache.cache_counters()
    with _FetchCounter() as fetches:
        srv = serve_loop.BatchedServer(params, cfg, capacity=capacity, eos_id=-1,
                                       mode="continuous", settings={"max_batch": max_batch},
                                       device=device, step=step)
        if device.type == "cuda":
            torch.cuda.synchronize()
        for fn in kernels.values():                  # counts of this path only
            fn.launches = 0
        t0 = time.perf_counter()
        metrics = traffic.replay(srv, arrivals)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
    fetches_continuous = len(fetches.rows)

    widths = [srv._width_of(len(a.prompt)) for a in arrivals]
    for a, r in zip(arrivals, (srv.results[i] for i in range(len(arrivals)))):
        if not 1 <= len(r.tokens) <= a.budget:
            raise AssertionError(f"request {r.rid}: {len(r.tokens)} tokens, budget {a.budget}")
    if int(metrics["completed"]) != len(arrivals):
        raise AssertionError(f"{metrics['completed']} of {len(arrivals)} requests completed")
    steps, syncs = int(metrics["decode_steps"]), int(metrics["decode_syncs"])
    if not fetches_continuous == syncs == math.ceil(steps / srv.sync_interval):
        raise AssertionError(f"_host_fetch ran {fetches_continuous} times for {steps} decode steps "
                             f"at sync_interval {srv.sync_interval} ({syncs} syncs)")
    prefills, captures = _prefill_terms(srv)
    expected = (_expected_launches(cfg, prefills + captures) if device.type == "cuda"
                else dict.fromkeys(kernels, 0))     # a CPU tensor never reaches a kernel
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} for ({prefills} prefills + {captures} "
                             f"captures) x {attention_passes(cfg)} attention calls of "
                             f"{cfg.family}; "
                             f"expected {expected}")
    registry = {k: v - registry0[k] for k, v in compilecache.cache_counters().items()}

    found = _divergences(srv, params, cfg, arrivals, capacity, device) if divergences else []
    return {"metrics": metrics, "wall_s": wall, "launches": launches,
            "prefill_calls": prefills, "captures": captures, "host_fetches": fetches_continuous,
            "widths": widths, "identical_share": 1.0 - len(found) / len(arrivals),
            "divergences": found, "params": params, "arrivals": arrivals,
            "streams": _streams(srv), "server": srv, "registry": registry,
            "step": srv.step_mode}


def phase_serve(device, card: str, name: str = "olmo-1b", n_requests: int = 16,
                widths: Optional[list] = None, label: str = "serve", capacity: int = 2048,
                max_width: int = 1024, n_layers: Optional[int] = None,
                divergences: bool = True) -> dict:
    """Serve the full-width model ``name`` (its depth cut to ``n_layers``
    where given) on the card; see :func:`serve_main_path`.  Without
    ``divergences`` the one-at-a-time replay is left out."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    depth = f"{cfg.n_layers} layers"
    if cfg.family == "encdec":
        depth = f"{cfg.enc_layers} encoder + {cfg.n_layers} decoder layers"
    elif cfg.family == "vlm":
        depth = f"{cfg.n_layers} layers + {cfg.n_layers // cfg.cross_attn_period} cross blocks"
    if n_layers is not None:
        depth = f"depth cut to {n_layers} of {cfg.n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=n_layers).validate()
    out = serve_main_path(device, cfg, capacity=capacity, max_batch=8, n_requests=n_requests,
                          max_width=max_width, widths=widths, divergences=divergences)
    out.update(widths_asked=widths, capacity=capacity, max_width=max_width)
    m = out["metrics"]
    launched = ", ".join(f"{n} {k} launches" for k, n in out["launches"].items() if n)
    source = ""
    if cfg.family in ("encdec", "vlm"):
        source = (f", {cfg.num_modal_tokens or max(2, capacity // 4)} zero modal frames a "
                  f"request (the stub)")
    print(f"{label}: {name} full width ({depth}, d {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f} B params, bf16), capacity {capacity}{source} on {card}")
    print(f"{label}: {int(m['completed'])} requests, widths {sorted(set(out['widths']))}, "
          f"{int(m['total_tokens'])} tokens, {int(m['decode_steps'])} decode steps, "
          f"{out['host_fetches']} host fetches, step={out['step']}: {out['prefill_calls']} "
          f"prefills + {out['captures']} prefill captures, {launched} (= (prefills + "
          f"captures) x {attention_passes(cfg) or cfg.n_layers} call sites); registry "
          f"{_registry_line(out['registry'])}")
    print(f"{label}: smoke reading, one cold run: continuous tokens_per_s "
          f"{m['tokens_per_s']:.2f}, p50_latency_s {m['p50_latency_s']:.4f}, "
          f"p99_latency_s {m['p99_latency_s']:.4f} ({card})")
    if not divergences:
        print(f"{label}: (the one-at-a-time replay is not run here: the graphs phase gates "
              "eager against graph streams)")
    else:
        print(f"{label}: gang vs continuous identical token streams: "
              f"{out['identical_share']:.3f} of requests")
    for d in out["divergences"]:
        print(f"{label}: divergence rid {d['rid']} at step {d['step']}: "
              f"top-2 logit gap at batch 1 {d['top2_gap']:.4g}")
    if out["divergences"] and cfg.is_moe:
        print(f"{label}: (reported, not a gate: expert capacity couples the rows of a batch, so "
              "a MoE stream at batch 8 and one at batch 1 need not agree)")
    elif out["divergences"]:
        print(f"{label}: (reported, not a gate: in bf16 a decode step at batch 8 and one at "
              "batch 1 round differently; the f32 serve in the model phase must agree)")
    out["cfg"] = cfg
    del out["server"]               # its graphs and caches go with it
    return out


def _registry_line(c: dict) -> str:
    return (f"captures {int(c['captures'])}, replays {int(c['replays'])}, build "
            f"{c['build_seconds']:.2f} s, hits {int(c['hits'])}, misses {int(c['misses'])}")


def _release() -> None:
    """Free what the phases before held: the servers' handed-over graphs and
    buffers (which hold their params), then the allocator's cache."""
    from repro_torch.core import compilecache

    compilecache.drop_handed_over()
    gc.collect()
    torch.cuda.empty_cache()


def _memory(label: str, t_start: float) -> None:
    print(f"{label}: torch.cuda.max_memory_reserved {torch.cuda.max_memory_reserved() / 2**30:.2f} "
          f"GiB, memory_reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB; "
          f"{time.perf_counter() - t_start:.1f} s since the start")


# --------------------------------------------------------------- background
_BACKGROUND: list = []


class Background:
    """A command started now in a process group of its own, its standard
    output and errors into files under ``workdir``, and read by
    :meth:`finish` later, so the phases in between run beside it.
    :meth:`stop` kills the group (the command and whatever it started) and
    removes ``workdir``; :func:`stop_background` stops every one still
    open."""

    def __init__(self, argv: list, workdir: Path, *, timeout: float):
        self.dir, self.timeout = Path(workdir), timeout
        self.what = " ".join(str(a) for a in argv[1:])
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        self.t0 = time.perf_counter()
        with open(self.dir / "out.log", "w") as out, open(self.dir / "err.log", "w") as err:
            self.proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out, stderr=err,
                                         start_new_session=True)
        _BACKGROUND.append(self)

    def finish(self, label: str) -> float:
        """Wait for the command (at most ``timeout`` from its start), print
        its output under ``label`` and raise unless it exited 0; the
        seconds spent waiting here."""
        t0 = time.perf_counter()
        left = self.timeout - (t0 - self.t0)
        try:
            rc = self.proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"{label}: {self.what} did not end within "
                                 f"{self.timeout:.0f} s") from None
        waited = time.perf_counter() - t0
        for line in (self.dir / "out.log").read_text().splitlines():
            if line.strip():
                print(f"{label}: {line}")
        if rc != 0:
            err = (self.dir / "err.log").read_text()[-4000:]
            self.stop()
            raise AssertionError(f"{label}: {self.what} exited {rc}:\n{err}")
        return waited

    def stop(self) -> None:
        import shutil
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:                     # the whole group has ended
            pass
        self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)
        if self in _BACKGROUND:
            _BACKGROUND.remove(self)


def stop_background() -> None:
    for bg in list(_BACKGROUND):
        bg.stop()


def runner_args(name: str, out_dir, *, quick: bool) -> list:
    """``repro_torch.bench.runner``'s arguments for one twin, its JSON and
    trajectory under ``out_dir``, its check on (the runner's default)."""
    return (["--only", name, "--out-dir", str(out_dir),
             "--trajectory", str(Path(out_dir) / "trajectory.jsonl")]
            + (["--quick"] if quick else []))


def start_twin(name: str, *, quick: bool, timeout: float) -> Background:
    """``python -m repro_torch.bench.runner`` for one twin on the card, in the
    background."""
    import tempfile

    workdir = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_"))
    return Background([sys.executable, "-m", "repro_torch.bench.runner",
                       *runner_args(name, workdir, quick=quick)], workdir, timeout=timeout)


# ------------------------------------------------------------------- graphs
GRAPH_DECODE_STEPS = 20


def decode_step_timing(srv, steps: int = GRAPH_DECODE_STEPS) -> dict:
    """``steps`` decode steps of a warm server (after its run: every slot
    done, so the state it advances is never read): CUDA events around them
    (device ms a step, host gaps included where the host is slower), the
    host's wall a step (enqueue to the end of the last step), and the
    device's busy time a step, idle share and four most costly kernels
    under torch.profiler (device activity only)."""
    def run():
        srv._hist_row.zero_()                   # the history takes at most 64 steps
        for _ in range(steps):
            srv._decode()

    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    out = {"events_ms": start.elapsed_time(end) / steps, "host_ms": 1e3 * wall / steps}
    found = _device_profile(lambda: (run(), torch.cuda.synchronize()), host=False)
    if found is not None:
        busy, window, n_ops, by_name = found
        out.update(busy_ms=busy / 1e3 / steps, idle_share=1 - busy / window,
                   ops_per_step=n_ops / steps,
                   top=sorted(((us / 1e3 / steps, name) for name, us in by_name.items()),
                              reverse=True)[:4])
    return out


def phase_graphs(device, card: str, serves: dict, label: str = "graphs") -> dict:
    """Each full-width model (the serve phases' weights, smoke mix and
    capacity, bf16, max_batch 8) served with ``step="eager"`` and with
    ``step="graph"``: the same step bodies on the same static buffers,
    without and with capture.  Fails unless every request's token stream is
    identical between the two and the launch counts are exact on both.
    Prints, per path, tokens/s and p50/p99 of the run (a graph server
    captures during it), the decode step's device and host time, the
    registry's counters, and the graphed step's costliest kernels."""
    out = {}
    for name, serve in serves.items():
        cfg = serve["cfg"]
        runs = {}
        for step in ("eager", "graph"):
            r = serve_main_path(device, cfg, capacity=serve["capacity"], max_batch=8,
                                n_requests=len(serve["arrivals"]),
                                max_width=serve["max_width"], widths=serve["widths_asked"],
                                step=step, params=serve["params"], divergences=False)
            r["decode"] = decode_step_timing(r.pop("server"))
            runs[step] = r
            m, d = r["metrics"], r["decode"]
            print(f"{label}: {name} step={step}: tokens_per_s {m['tokens_per_s']:.2f}, "
                  f"p50_latency_s {m['p50_latency_s']:.4f}, p99_latency_s "
                  f"{m['p99_latency_s']:.4f}; decode step at batch 8: {d['events_ms']:.3f} ms "
                  f"by events, host wall {d['host_ms']:.3f} ms, device busy "
                  f"{d.get('busy_ms', float('nan')):.3f} ms (idle share "
                  f"{d.get('idle_share', float('nan')):.3f}, "
                  f"{d.get('ops_per_step', float('nan')):.0f} device ops a step); "
                  f"{r['prefill_calls']} prefills + {r['captures']} captures, launches "
                  f"{r['launches']}; registry {_registry_line(r['registry'])} ({card})")
            if step == "graph":
                for ms, kname in d.get("top", []):
                    print(f"{label}: {name} step=graph: {ms:.3f} ms a step  {kname[:90]}")
        eager, graph = runs["eager"]["streams"], runs["graph"]["streams"]
        differ = [rid for rid in eager if eager[rid] != graph[rid]]
        for rid in differ:
            t = next(i for i, (x, y) in enumerate(zip(eager[rid], graph[rid])) if x != y)
            print(f"{label}: {name}: request {rid} differs at step {t}: eager "
                  f"{eager[rid][t:t + 4]}, graph {graph[rid][t:t + 4]}")
        if differ:
            raise AssertionError(f"{name}: {len(differ)} of {len(eager)} token streams differ "
                                 "between the eager and the graph path")
        print(f"{label}: {name}: eager and graph streams identical for {len(eager)} of "
              f"{len(eager)} requests; decode step {runs['eager']['decode']['events_ms']:.3f} -> "
              f"{runs['graph']['decode']['events_ms']:.3f} ms by events")
        out[name] = {step: {k: v for k, v in r.items() if k in ("metrics", "decode", "launches",
                                                               "registry")}
                     for step, r in runs.items()}
    out["launches"] = {k: sum(r[step]["launches"][k] for r in out.values() for step in r)
                       for k in _kernels()}
    return out


# -------------------------------------------------------------------- model
def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _model_moe_streams(device, cfg, name: str) -> None:
    """A reduced MoE config served on the card eagerly and on graphs: the
    streams must be identical (one-at-a-time decoding is not the contract:
    expert capacity couples the rows of a batch)."""
    runs = {step: serve_main_path(device, cfg, capacity=64, max_batch=4, n_requests=8,
                                  max_width=32, long_max=16, step=step, divergences=False)
            for step in ("eager", "graph")}
    eager, graph = runs["eager"]["streams"], runs["graph"]["streams"]
    if eager != graph:
        differ = [rid for rid in eager if eager[rid] != graph[rid]]
        raise AssertionError(f"reduced {name}: streams {differ} differ between the eager and "
                             "the graph path")
    g = runs["graph"]
    launched = ", ".join(f"{n} {k}" for k, n in g["launches"].items() if n)
    print(f"model: reduced {name} f32 served on the card: eager and graph streams identical "
          f"for {len(eager)} of {len(eager)} requests; graph path {g['prefill_calls']} prefills "
          f"+ {g['captures']} captures, kernel launches {launched}")


def phase_model(device, name: str) -> float:
    """A reduced config in float32: card (kernel path) vs CPU (plain path),
    prefill at widths 24 (non-pow2: ragged kernel tiles and chunks; past
    a reduced window of 16) and 2 (shorter than the SSM's conv history) + 3
    decode steps; then served on the card (a MoE config: eager against
    graph streams)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(name).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(5)
    fed = torch.from_numpy(rng.integers(2, cfg.vocab_size, (3, 2)))   # decode inputs

    def run(dev, toks):
        p = _to(params, dev)
        logits, caches, pos = M.prefill(p, cfg, toks.to(dev), 32)
        outs = [logits]
        for tok in fed.to(dev):
            logits, caches = M.decode_step(p, cfg, tok, caches, pos)
            pos += 1
            outs.append(logits)
        return [o.cpu() for o in outs]

    worst = 0.0
    for width in (24, 2):
        toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, width)))
        for got, want in zip(run(device, toks), run("cpu", toks)):
            if got.shape != (2, cfg.padded_vocab) or not torch.isfinite(got).all():
                raise AssertionError(f"{name}: logits of shape {tuple(got.shape)}, "
                                     f"finite {bool(torch.isfinite(got).all())}")
            worst = max(worst, (got - want).abs().max().item())
    if worst > 1e-4:
        raise AssertionError(f"reduced {name} on the card vs the CPU: max abs logit err {worst}")
    print(f"model: reduced {name} f32 prefill (S=24, S=2) + 3 decode steps, card vs CPU: "
          f"max abs logit err {worst:.3g} (tol 1e-4)")

    if cfg.is_moe:
        _model_moe_streams(device, cfg, name)
        return worst
    # In f32 the continuous server must reproduce the one-at-a-time streams
    # on the card too; only an argmax near-tie (top-2 gap under the 1e-4
    # logit tolerance above) may differ.
    out = serve_main_path(device, cfg, capacity=64, max_batch=4, n_requests=8, max_width=32,
                          long_max=16)
    ties = [d for d in out["divergences"] if d["top2_gap"] >= 1e-4]
    if ties:
        raise AssertionError(f"{name}: f32 continuous vs sequential streams differ beyond "
                             f"near-ties: {ties}")
    launched = ", ".join(f"{n} {k}" for k, n in out["launches"].items() if n)
    out.pop("server")
    print(f"model: reduced {name} f32 served on the card (step={out['step']}): "
          f"{out['prefill_calls']} prefills + {out['captures']} captures, "
          f"kernel launches {launched}, identical streams "
          f"{out['identical_share']:.3f} of requests (near-ties {len(out['divergences'])})")
    return worst


# ------------------------------------------------------------------ profile
# kernel → the parts of its device-side names (csrc/*.cu): every pass of ssd_tc
PORT_KERNELS = {"flash_attention": ("flash_attention_",),
                "ssd": ("ssd_fwd_kernel", "ssd_tc_states_kernel", "ssd_tc_pass_kernel",
                        "ssd_tc_scan_kernel"),
                "rmsnorm": ("rmsnorm_fwd_kernel",)}


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _device_profile(fn, host: bool = True) -> Optional[tuple]:
    """``fn()`` under torch.profiler, tracing the host's ops too unless
    ``host`` is false: (device busy µs, window µs from the first device op's
    start to the last one's end, device ops, µs by kernel name), or None
    when the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        fn()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    return _busy_us(spans), window, len(kernels), by_name


def phase_profile(device, serve: dict, card: str, step: str, top: int = 8) -> None:
    """A main path's requests again on a warm server of the given ``step``
    path: one replay plain (warm tokens/s and p50; the first run paid cuBLAS
    and allocator set-up, and a graph server its captures), one more on the
    same server under torch.profiler for the device's busy share and the
    kernels that take its time."""
    from repro_torch.runtime import serve_loop, traffic

    cfg = serve["cfg"]
    tag = f"profile {cfg.name} step={step}"
    srv = serve_loop.BatchedServer(serve["params"], cfg, capacity=2048, eos_id=-1,
                                   settings={"max_batch": 8}, device=device, step=step)

    def serve_once():
        m = traffic.replay(srv, serve["arrivals"])
        torch.cuda.synchronize()
        return m

    serve_once()
    m = serve_once()
    print(f"{tag}: warm rerun tokens_per_s {m['tokens_per_s']:.2f}, "
          f"p50_latency_s {m['p50_latency_s']:.4f} ({card})")
    found = _device_profile(serve_once, host=False)
    if found is None:
        print(f"{tag}: the profiler recorded no device activity")
        return
    busy, window, n_ops, by_name = found
    total = sum(by_name.values())
    print(f"{tag}: device busy {busy / 1e3:.1f} ms of a {window / 1e3:.1f} ms window "
          f"(idle share {1 - busy / window:.3f}, device activity only), {n_ops} device ops")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{tag}: {us / total:6.3f} of device time, {us / 1e3:8.2f} ms  {name[:90]}")
    for kernel, markers in PORT_KERNELS.items():
        us = sum(t for name, t in by_name.items() if any(m in name for m in markers))
        print(f"{tag}: the port's {kernel} kernel: {us / total:.4f} of device time, "
              f"{us / 1e3:.2f} ms")


# ------------------------------------------------------------------- timing
def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernels_us(fn, reps: int = 20) -> dict:
    """Device kernel name → (µs, launches) a call of ``fn()``, under
    torch.profiler (host gaps left out; device activity only: with CPU
    activity too, a process's first profile recorded no device events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = out.get(e.name, (0.0, 0))
            out[e.name] = (us + e.time_range.elapsed_us() / reps, n + 1)
    return {name: (us, n // reps) for name, (us, n) in out.items()}


def _device_ms(fn, reps: int = 20) -> tuple:
    """Device time of one call of ``fn`` (the sum of its kernels) and the
    kernels a call launches."""
    kernels = _kernels_us(fn, reps).values()
    return sum(us for us, _ in kernels) / 1e3, sum(n for _, n in kernels)


def _both_ms(fn, *tensors, reps: int = 20) -> tuple:
    """(events ms, device-held ms) of one call of ``fn(*tensors)``.  Events
    over ``reps`` eager calls read the host's dispatch rate wherever it is
    slower than the card; the device-held reading is the median of the
    tuner's samples (``launch.microbench.time_samples_us``: 10 calls queued
    behind a device-side hold, so the card runs them back to back)."""
    from repro_torch.launch.microbench import time_samples_us

    events = _time_ms(lambda: fn(*tensors), reps)
    held = float(np.median(time_samples_us(fn, *tensors, reps=5))) / 1e3
    return events, held


def attention_bound_ms(b: int, s: int, h: int, kh: int, d: int, elem_bytes: int,
                       peak_flops: float) -> tuple:
    """Least time for causal attention at these shapes: q, k, v read once and
    o written once, against 4·d FLOPs per unmasked (q, k) pair."""
    bytes_moved = elem_bytes * d * (2 * b * s * h + 2 * b * s * kh)
    flops = 4.0 * d * b * h * s * (s + 1) / 2
    t_bytes, t_flops = bytes_moved / PEAK_BYTES, flops / peak_flops
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


# name: (batch, seq, heads, kv_heads, head_dim, window), bf16, causal; every
# window is wider than its sequence, so SDPA's causal mask is the same function
ATTN_TIMED = {
    "olmo-1b prefill": (1, 1024, 16, 16, 128, 0),
    "hymba-1.5b prefill": (1, 1024, 25, 5, 64, 2048),
    **{f"grid b{b}q{s}": (b, s, 16, 16, 128, 0) for b, s in ((1, 128), (2, 256), (2, 512),
                                                              (4, 1024))},
}


def phase_timing(device) -> dict:
    """Flash attention at the default tiles, its plain version and SDPA at
    each ATTN_TIMED shape, on both yardsticks; the first shape is the
    kernel's headline row."""
    kernel, ref = _import_port()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n0 = kernel.flash_attention.launches
    rows = {}
    for name, (b, s, h, kh, d, window) in ATTN_TIMED.items():
        q, k, v = _qkv((b, s, s, h, kh, d, window, 0), torch.bfloat16, device, seed=7)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms, ms_dev = _both_ms(lambda *t: kernel.flash_attention(*t, causal=True, window=window),
                              q, k, v)
        plain, plain_dev = _both_ms(lambda *t: ref.naive_attention(*t, causal=True, window=window),
                                    q, k, v)
        lib, lib_dev = _both_ms(lambda *t: sdpa(*t, is_causal=True, enable_gqa=h != kh),
                                qt, kt, vt)
        bound_ms, bound_by = attention_bound_ms(b, s, h, kh, d, 2, PEAK_BF16_FLOPS)
        rows[name] = {"shape": f"bf16 B{b} S{s} H{h} K{kh} D{d} causal"
                      + (f" window {window}" if window else ""),
                      "ms": ms, "ms_device": ms_dev, "plain_ms": plain,
                      "plain_ms_device": plain_dev, "library_ms": lib,
                      "library_ms_device": lib_dev, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"timing: flash_attention {rows[name]['shape']} ({name}), events / device-held: "
              f"kernel {ms:.4f} / {ms_dev:.4f} ms, plain {plain:.4f} / {plain_dev:.4f} ms, "
              f"SDPA {lib:.4f} / {lib_dev:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    kernel.flash_attention.launches = n0     # timing launches are not the main path's
    return {**rows["olmo-1b prefill"], "shapes": rows}


def ssd_bound_ms(b: int, s: int, h: int, p: int, n: int, g: int, elem_bytes: int,
                 chunk: int, peak_flops: float) -> tuple:
    """Least time for the SSD forward at these shapes: x, B, C, dt, A, D read
    once, y and the f32 final state written once, against the chunked
    algorithm's FLOPs at ``chunk``: the causal half of C·Bᵀ once per group
    (every head of a group shares it), and per head the causal half of the
    intra-chunk product and the inter-chunk and state products."""
    bytes_moved = (elem_bytes * (2 * b * s * h * p + 2 * b * s * g * n)
                   + 4 * (b * s * h + 2 * h) + 4 * b * h * p * n)
    flops = 0.0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs = q * (q + 1) / 2
        flops += 2.0 * b * g * pairs * n + 2.0 * b * h * (pairs * p + 2 * q * n * p)
    t_bytes, t_flops = bytes_moved / PEAK_BYTES, flops / peak_flops
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


# name: (batch, seq, heads, head_dim, state, groups), bf16, chunk 64
SSD_TIMED = {
    "mamba2-780m prefill": (1, 1024, 48, 64, 128, 1),
    "hymba-1.5b prefill": (1, 1024, 25, 128, 16, 1),
    "grid b1s256h48": (1, 256, 48, 64, 128, 1),
    "grid b2s512h48": (2, 512, 48, 64, 128, 1),
}


def phase_timing_ssd(device) -> dict:
    """The SSD kernel (bf16: ``ssd_tc``) and its plain version at each
    SSD_TIMED shape, and the float32 FMA kernel (``ssd``) at mamba2-780m's,
    on both yardsticks; the first shape is the kernel's headline row.  No
    PyTorch call computes SSD."""
    from repro_torch.kernels.ssd import kernel, ref

    n0 = kernel.ssd.launches
    rows = {}
    timed = [(name, case, torch.bfloat16) for name, case in SSD_TIMED.items()]
    timed.append(("mamba2-780m prefill f32", SSD_TIMED["mamba2-780m prefill"], torch.float32))
    for name, case, dtype in timed:
        t = _ssd_inputs(case, dtype, device, seed=8)
        ms, ms_dev = _both_ms(lambda *a: kernel.ssd(*a, chunk=64, return_state=True), *t)
        plain, plain_dev = _both_ms(
            lambda *a: ref.ssd_chunked(*a, chunk=ref.align_chunk(64, case[1]), return_state=True),
            *t)
        elem, peak = (2, PEAK_BF16_FLOPS) if dtype == torch.bfloat16 else (4, PEAK_F32_FLOPS)
        bound_ms, bound_by = ssd_bound_ms(*case, elem, 64, peak)
        b, s, h, p, n, g = case
        rows[name] = {"shape": f"{'bf16' if elem == 2 else 'f32'} B{b} S{s} H{h} P{p} N{n} G{g}",
                      "source": kernel.SOURCES[dtype], "ms": ms, "ms_device": ms_dev,
                      "plain_ms": plain, "plain_ms_device": plain_dev, "library_ms": None,
                      "library_ms_device": None, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"timing: ssd ({kernel.SOURCES[dtype]}) {rows[name]['shape']} chunk 64 ({name}), "
              f"events / device-held: kernel {ms:.4f} / {ms_dev:.4f} ms, plain ssd_chunked "
              f"{plain:.4f} / {plain_dev:.4f} ms, no library call computes SSD, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        if dtype == torch.bfloat16:   # each pass of ssd_tc (the scan overlaps pass 2's end)
            passes = {next(m for m in PORT_KERNELS["ssd"] if m in k): us for k, (us, _) in
                      _kernels_us(lambda: kernel.ssd(*t, chunk=64), reps=10).items()}
            rows[name]["passes_us"] = passes
            print(f"timing: ssd ({kernel.SOURCES[dtype]}) {name}, per pass (profiler, kernel "
                  "durations): " + (", ".join(f"{k} {us:.1f} us" for k, us in passes.items())
                                    or "the profiler recorded no device activity"))
    kernel.ssd.launches = n0                 # timing launches are not the main path's

    # the plain one-token update at the mamba2 serve's decode shape (8 slots):
    # its f32 state must at least be read and written once a layer.  Events
    # around eager calls time the host's dispatch too; the profiler's sum of
    # the device kernels gives the card's own share.
    x, dt, A, B, C, D = _ssd_inputs((8, 1, 48, 64, 128, 1), torch.bfloat16, device, seed=9)
    state = torch.randn((8, 48, 64, 128), device=device)
    step = lambda: ref.ssd_decode_step(state, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)
    decode_ms = _time_ms(step)
    decode_device_ms, decode_ops = _device_ms(step)
    decode_bound_ms = 1e3 * 2 * state.numel() * 4 / PEAK_BYTES
    print(f"timing: ssd_decode_step (plain) bf16 B8 H48 P64 N128, one layer: {decode_ms:.4f} ms "
          f"by events (host dispatch included), {decode_device_ms:.4f} ms of device kernels "
          f"({decode_ops} kernels); x 48 layers {48 * decode_device_ms:.4f} ms of device time "
          f"a decode step; bound (state read + written once) {decode_bound_ms:.4f} ms a layer")
    return {**rows["mamba2-780m prefill"], "shapes": rows}


def rmsnorm_bound_ms(rows: int, d: int, elem_bytes: int, scale_bytes: int,
                     residual: bool) -> tuple:
    """Least time for RMSNorm at these shapes: x (and the residual) read
    once, the scale read once, y written once, against 4 FLOPs per element
    (square and add, the two multiplies; 5 with the residual's add) at the
    card's float32 rate."""
    n = rows * d
    bytes_moved = elem_bytes * n * (3 if residual else 2) + scale_bytes * d
    flops = (5.0 if residual else 4.0) * n
    t_bytes, t_flops = bytes_moved / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def phase_timing_rmsnorm(device) -> dict:
    """The kernel (default launch: 1 row a block, 32 threads a row), the
    plain version and ``torch.nn.functional.rms_norm`` (a yardstick the port
    never calls) at the grid's r16384d1536 in bf16, with a bf16 scale, on
    both yardsticks."""
    from repro_torch.kernels.rmsnorm import kernel, ref

    rows, d = 16384, 1536
    x, r, scale = _rms_inputs((rows, d), torch.bfloat16, device, 11)
    scale = scale.to(torch.bfloat16)
    n0 = kernel.rmsnorm.launches
    out = {}
    for residual in (False, True):
        args = (x, scale, r) if residual else (x, scale)
        k_ms, k_dev = _both_ms(kernel.rmsnorm, *args)
        p_ms, p_dev = _both_ms(ref.rmsnorm, *args)
        lib_ms, lib_dev = (None, None) if residual else _both_ms(
            lambda x, scale: torch.nn.functional.rms_norm(x, (d,), scale, eps=1e-5), *args)
        b_ms, b_by = rmsnorm_bound_ms(rows, d, 2, 2, residual)
        tag = "rmsnorm_res" if residual else "rmsnorm"
        out[tag] = {"ms": k_ms, "ms_device": k_dev, "plain_ms": p_ms, "plain_ms_device": p_dev,
                    "library_ms": lib_ms, "library_ms_device": lib_dev, "bound_ms": b_ms,
                    "bound_by": b_by}
        print(f"timing: {tag} bf16 r{rows}d{d}, events / device-held: kernel {k_ms:.4f} / "
              f"{k_dev:.4f} ms, plain {p_ms:.4f} / {p_dev:.4f} ms, "
              + (f"F.rms_norm {lib_ms:.4f} / {lib_dev:.4f} ms, " if lib_ms is not None else
                 "no single library call normalizes x + residual, ")
              + f"bound {b_ms:.4f} ms ({b_by})")
    kernel.rmsnorm.launches = n0             # timing launches are not the main path's
    return out


# ----------------------------------------------------------------- campaign
def _op_check(component: str, workload: str, device) -> tuple:
    """Call the component's op at the workload's shape with no settings
    given, so it resolves what the store holds; returns (launches added,
    max abs err against the plain version)."""
    from repro_torch.core.configstore import _sig_fields
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    f = _sig_fields(workload)
    if component == "torch_flash_attention":
        q, k, v = _qkv((f["b"], f["q"], f["k"], 16, 16, f["d"], 0, 0), torch.bfloat16, device, 41)
        wrapper = fa_kernel.flash_attention
        n0 = wrapper.launches
        got = fa_ops.flash_attention(q, k, v, causal=True)
        want, tol = fa_ref.naive_attention(q, k, v, causal=True), TOL[torch.bfloat16]
    elif component == "torch_rmsnorm_kernel":
        x, _, scale = _rms_inputs((f["r"], f["d"]), torch.bfloat16, device, 42, residual=False)
        wrapper = rms_kernel.rmsnorm
        n0 = wrapper.launches
        got = rms_ops.rmsnorm(x, scale)
        want, tol = rms_ref.rmsnorm(x, scale), TOL[torch.bfloat16]
    else:
        t = _ssd_inputs((f["b"], f["s"], f["h"], 64, 128, 1), torch.bfloat16, device, 43)[:5]
        wrapper = ssd_kernel.ssd
        n0 = wrapper.launches
        got = ssd_ops.ssd(*t)
        want = ssd_ref.ssd_chunked(*t, chunk=ssd_ref.align_chunk(64, f["s"]))
        tol = TOL[torch.bfloat16] * SSD_HEADROOM
    torch.cuda.synchronize()
    added = wrapper.launches - n0
    err = (got.float() - want.float()).abs()
    if not torch.isfinite(got).all() or (err > tol + tol * want.float().abs()).any():
        raise AssertionError(f"{component}@{workload}: the op at the promoted settings disagrees "
                             f"with the plain version: max abs err {err.max().item():.3g}, "
                             f"tol {tol:.3g}")
    return added, err.max().item()


def phase_campaign(device, card: str) -> dict:
    """The full ``kernels`` grid on the card into a temporary store and
    journal (the default store for this phase only); returns the launches
    per kernel during the grid's run."""
    import tempfile

    from repro_torch.core import configstore
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import campaign as launch

    kernels = _kernels()
    singletons = {"torch_flash_attention": fa_ops.attention_settings,
                  "torch_rmsnorm_kernel": rms_ops.rmsnorm_settings,
                  "torch_ssd_kernel": ssd_ops.ssd_settings}
    hw, sw = configstore.hardware_fingerprint(), configstore.sw_fingerprint()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_campaign_") as tmp:
        store = configstore.ConfigStore(Path(tmp) / "store")
        journal_root = Path(tmp) / "journal"
        old = configstore.set_default_store(store)
        try:
            torch.cuda.synchronize()
            for fn in kernels.values():              # counts of this path only
                fn.launches = 0
            t0 = time.perf_counter()
            camp, results = launch.run_grid("kernels", budget=6, optimizer="bo", seed=0,
                                            device=device, campaign_id="chip-smoke",
                                            store=store, journal_root=journal_root)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in kernels.items()}
            print(f"campaign: kernels grid, {len(results)} cells, bo budget 6, "
                  f"{camp.measure_calls} measurements, wall {wall:.1f} s, on {card}")
            for _, r in sorted(results.items()):
                print("campaign: " + launch.describe(r))

            cell_ids = {c.cell_id for c in camp.cells}
            if len(cell_ids) != 8 or set(camp.journal.completed()) != cell_ids:
                raise AssertionError(f"cells without a cell_done row: "
                                     f"{sorted(cell_ids - set(camp.journal.completed()))}")
            for comp in singletons:
                path = store.root / f"{comp}.json"
                entries = json.loads(path.read_text())["entries"] if path.exists() else []
                for e in entries:
                    if e["context"]["hardware"] != hw or e["context"]["sw"] != sw:
                        raise AssertionError(f"promoted entry filed under {e['context']}, "
                                             f"not {hw} / {sw}")
            if not all(launches.values()):
                raise AssertionError(f"a kernel was not launched by the grid: {launches}")
            print(f"campaign: launches during the grid {launches}; entries filed under {hw}, {sw}")

            again, res2 = launch.run_grid("kernels", budget=6, optimizer="bo", seed=0,
                                          device=device, campaign_id="chip-smoke",
                                          store=store, journal_root=journal_root)
            if again.measure_calls != 0 or not all(r.resumed for r in res2.values()):
                raise AssertionError(f"resume re-measured: {again.measure_calls} calls")
            print(f"campaign: rerun under the same id resumed {len(res2)} cells, "
                  f"{again.measure_calls} measurements")

            for comp in singletons:
                if not any(r.promoted for r in results.values() if r.cell.component == comp):
                    raise AssertionError(f"{comp}: no cell promoted")
            for _, r in sorted(results.items()):
                if not r.promoted:
                    continue
                resolved = singletons[r.cell.component].settings_for(r.cell.workload)
                if resolved != r.best_config:
                    raise AssertionError(f"{r.cell.cell_id}: settings_for gives {resolved}, "
                                         f"promoted {r.best_config}")
                added, err = _op_check(r.cell.component, r.cell.workload, device)
                if added != 1:
                    raise AssertionError(f"{r.cell.cell_id}: the op launched its kernel "
                                         f"{added} times, not once")
                print(f"campaign: {r.cell.cell_id} resolves {resolved}; the op launched its "
                      f"kernel once, max abs err vs plain {err:.3g}")
        finally:
            configstore.set_default_store(old)
    print(f"campaign: phase wall {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "wall_s": wall}


# ------------------------------------------------------------------- online
ONLINE_SEED = 1              # the tuner's: its first random proposals fall on both sides of 16
ONLINE_KINDS = {"canary_start": ("seq", "challenger", "champion", "windows"),
                "canary_verdict": ("seq", "challenger", "verdict"),
                "promote": ("seq", "settings"),
                "rollback": ("seq", "restored", "reason")}


def _check_journal(rows, tuner_id: str) -> None:
    from repro_torch.runtime.online import ONLINE_SCHEMA_VERSION

    for i, row in enumerate(rows):
        need = ONLINE_KINDS.get(row.get("kind"))
        if (need is None or row.get("schema") != ONLINE_SCHEMA_VERSION
                or row.get("tuner") != tuner_id or any(k not in row for k in need)
                or not isinstance(row["seq"], int)):
            raise AssertionError(f"online journal row {i} is malformed: {row}")


def online_main_path(device, cfg, *, capacity: int, params=None, budget: int = 3,
                     windows_per_eval: int = 4, init_seed: int = 0) -> dict:
    """The live server under the online tuner: the online benchmark's adapt
    phase (``repro_torch.bench.online_tuning.make_tuner`` and ``adapt``) on
    a continuous server at its stale settings (``sync_interval`` 16) over
    the post-shift ``traffic.drifting`` slice, until a challenger promotes
    or the budget is spent, with the journal and store in a temporary
    directory (the default store for the phase).  Raises on a malformed
    journal row, a prefill that bypassed its kernels, a host fetch outside
    the one per sync, a resumed tuner that does not restore the champion
    and the remaining budget, or a resolve that does not return a promoted
    ``sync_interval``."""
    import tempfile

    from repro_torch.bench import online_tuning as twin
    from repro_torch.core import config, configstore
    from repro_torch.models import model as M
    from repro_torch.runtime import online, serve_loop

    device = torch.device(device)
    kernels = _kernels()
    if params is None:
        params = M.init_params(cfg, torch.Generator(device=device).manual_seed(init_seed),
                               device=device)
    _, post = twin.split_arrivals(7, quick=False)

    def tuner_on(server, root, tuner_id=None):
        return twin.make_tuner(server, store, root / "journal", budget=budget,
                               windows_per_eval=windows_per_eval, seed=ONLINE_SEED,
                               tuner_id=tuner_id)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_online_") as tmp:
        root = Path(tmp)
        store = configstore.ConfigStore(root / "store")
        old = configstore.set_default_store(store)
        try:
            srv = serve_loop.BatchedServer(params, cfg, capacity=capacity, eos_id=-1,
                                           mode="continuous", settings=twin.SETTINGS_STALE,
                                           device=device)
            tuner = tuner_on(srv, root)
            if device.type == "cuda":
                torch.cuda.synchronize()
            for fn in kernels.values():              # counts of this path only
                fn.launches = 0
            t0 = time.perf_counter()
            with _FetchCounter() as fetches:
                replays = twin.adapt(tuner, post)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in kernels.items()}

            rows = tuner.journal.rows()
            _check_journal(rows, tuner.tuner_id)
            if len(fetches.rows) != srv.decode_syncs or sum(fetches.rows) != srv.decode_steps:
                raise AssertionError(f"_host_fetch ran {len(fetches.rows)} times carrying "
                                     f"{sum(fetches.rows)} decode steps; the server made "
                                     f"{srv.decode_syncs} syncs of {srv.decode_steps} steps")
            prefills, captures = _prefill_terms(srv)
            expected = (_expected_launches(cfg, prefills + captures) if device.type == "cuda"
                        else dict.fromkeys(kernels, 0))
            if launches != expected:
                raise AssertionError(f"kernel launches {launches} for ({prefills} prefills + "
                                     f"{captures} captures) x {cfg.n_layers} layers; "
                                     f"expected {expected}")

            n_verdicts = sum(r["kind"] == "canary_verdict" for r in rows)
            srv2 = serve_loop.BatchedServer(params, cfg, capacity=capacity, eos_id=-1,
                                            mode="continuous", settings=twin.SETTINGS_STALE,
                                            device=device)
            resumed = tuner_on(srv2, root, tuner_id=tuner.tuner_id)
            want_budget = max(1, budget - n_verdicts)
            if (resumed.champion != tuner.champion
                    or resumed._exhausted != (n_verdicts >= budget)
                    or resumed.core.session.budget != want_budget
                    or any(srv2.current_config()[k] != v for k, v in tuner.champion.items())):
                raise AssertionError(f"the resumed tuner has champion {resumed.champion}, "
                                     f"session budget {resumed.core.session.budget}; the journal "
                                     f"says {tuner.champion}, {want_budget}")
            resolved = config.resolve(online.COMPONENT, srv.workload)
            if tuner.promotions and resolved["sync_interval"] != tuner.champion["sync_interval"]:
                raise AssertionError(f"resolve gives sync_interval {resolved['sync_interval']}, "
                                     f"the tuner promoted {tuner.champion['sync_interval']}")
        finally:
            configstore.set_default_store(old)
    return {"rows": rows, "promotions": tuner.promotions, "rollbacks": tuner.rollbacks,
            "champion": tuner.champion, "resolved": resolved, "replays": replays,
            "wall_s": wall, "launches": launches, "prefill_calls": prefills,
            "captures": captures, "decode_steps": srv.decode_steps,
            "host_fetches": len(fetches.rows),
            "n_requests": replays * len(post), "workload": srv.workload}


def online_parity_path(device, cfg, *, capacity: int = 64, n_requests: int = 8,
                       max_width: int = 32, seed: int = SEED) -> dict:
    """The continuous server with an ``OnlineTuner`` in the loop (default
    knobs, one window per canary, so the scheduler is re-knobbed at nearly
    every sync) against the same requests one at a time (gang mode, batch
    1).  Returns the divergences with their top-2 logit gaps."""
    import tempfile

    from repro_torch.core import configstore
    from repro_torch.models import model as M
    from repro_torch.runtime import online, serve_loop, traffic

    device = torch.device(device)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(3), device=device)
    arrivals = smoke_arrivals(seed, n_requests, cfg.vocab_size, max_width, long_max=16)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_online_parity_") as tmp:
        srv = serve_loop.BatchedServer(params, cfg, capacity=capacity, eos_id=-1,
                                       mode="continuous", settings={"max_batch": 4},
                                       device=device)
        tuner = online.OnlineTuner(srv, store=configstore.ConfigStore(Path(tmp) / "store"),
                                   journal_root=Path(tmp) / "journal", optimizer="rs", budget=6,
                                   windows_per_eval=1, seed=ONLINE_SEED)
        with _FetchCounter() as fetches:
            traffic.replay(tuner, arrivals)
        canaries = sum(r["kind"] == "canary_start" for r in tuner.journal.rows())
    if len(fetches.rows) != srv.decode_syncs or sum(fetches.rows) != srv.decode_steps:
        raise AssertionError(f"_host_fetch ran {len(fetches.rows)} times for "
                             f"{srv.decode_syncs} syncs")
    divergences = _divergences(srv, params, cfg, arrivals, capacity, device)
    return {"divergences": divergences, "canaries": canaries, "n_requests": len(arrivals),
            "identical_share": 1.0 - len(divergences) / len(arrivals)}


def phase_online(device, card: str, serve: dict) -> dict:
    """Full-width OLMo-1B (the serve phase's weights, bf16) tuned live on
    the card; then reduced OLMo-1B in float32 with the tuner in the loop
    against the one-at-a-time gang."""
    from repro_torch.bench import online_tuning as twin
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = serve["cfg"]
    out = online_main_path(device, cfg, capacity=2048, params=serve["params"])
    print(f"online: {cfg.name} full width, bf16, capacity 2048, stale settings "
          f"{twin.SETTINGS_STALE}, post-shift drifting slice x {out['replays']} replays "
          f"({out['n_requests']} requests), the adapt phase of repro_torch.bench.online_tuning "
          f"(rs budget 3 x 4 window pairs, until a promotion or the budget is spent), on {card}")
    for r in out["rows"]:
        detail = {"canary_start": lambda: f"challenger {r['challenger']} vs {r['champion']}",
                  "canary_verdict": lambda: (f"{r['verdict']['verdict']} (effect "
                                             f"{r['verdict']['effect']:+.3f}, p "
                                             f"{r['verdict']['p_value']})"),
                  "promote": lambda: f"settings {r['settings']}",
                  "rollback": lambda: f"restored {r['restored']} ({r['reason']})"}[r["kind"]]()
        print(f"online: seq {r['seq']} {r['kind']}: {detail}")
    print(f"online: {out['promotions']} promotions, {out['rollbacks']} rollbacks, champion "
          f"{out['champion']}; config.resolve('torch_serve_batching', '{out['workload']}') -> "
          f"{out['resolved']}")
    print(f"online: {out['prefill_calls']} prefills + {out['captures']} prefill captures, "
          f"{out['decode_steps']} decode steps, {out['host_fetches']} host fetches (one per "
          f"sync), launches {out['launches']} (= (prefills + captures) x {cfg.n_layers} "
          f"layers); a resumed tuner restored the champion and the budget; wall "
          f"{out['wall_s']:.1f} s")

    small = get_config(cfg.name).reduced()
    par = online_parity_path(device, small)
    ties = [d for d in par["divergences"] if d["top2_gap"] >= 1e-4]
    if ties:
        raise AssertionError(f"reduced {cfg.name} f32 with the tuner in the loop: continuous vs "
                             f"sequential streams differ beyond near-ties: {ties}")
    print(f"online: reduced {cfg.name} f32 with the tuner in the loop ({par['canaries']} "
          f"canaries): identical streams {par['identical_share']:.3f} of {par['n_requests']} "
          f"requests (near-ties {len(par['divergences'])})")
    print(f"online: phase wall {time.perf_counter() - t0:.1f} s")
    return out


# -------------------------------------------------------------- serve-bench
def serve_bench_path(device, *, capacity: int, repeats: int, trajectory) -> dict:
    """``repro_torch.bench.serve_scenarios`` on the heavy-tail mix (full
    width on the card, reduced on the CPU): one
    warm-up replay per scheduler, then ``repeats`` each; its records go to
    ``trajectory``.  Returns the twin's result, the records read back and
    the launches of the run."""
    import tempfile

    from repro_torch.bench import serve_scenarios as twin
    from repro_torch.core import compilecache
    from repro_torch.core.baseline import BaselineStore

    kernels = _kernels()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    steps0 = compilecache.step_counts().get("serve.prefill", {})
    for fn in kernels.values():                      # counts of this path only
        fn.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_bench_") as tmp:
        records = twin.bench(quick=False, seed=7, device=device, capacity=capacity,
                             scenarios=["heavy_tail"], repeats=repeats, out_dir=tmp)
        res = json.loads((Path(tmp) / "serve_scenarios.json").read_text())
    launches = {name: fn.launches for name, fn in kernels.items()}
    store = BaselineStore(trajectory)
    store.append(records, quick=False)
    rows = list(store.rows())
    if len(rows) != len(records) or any(r["context"]["component"] != twin.COMPONENT
                                        for r in rows):
        raise AssertionError(f"the trajectory holds {rows}")
    n = res["scenarios"]["heavy_tail"]["n_requests"]
    warm = sum(w["prefills"] for w in res["warmup_graphs"].values())
    prefills = warm + repeats * (n + math.ceil(n / twin.MAX_BATCH))   # continuous: one a request
    steps = compilecache.step_counts().get("serve.prefill", {})
    ran = steps.get("runs", 0) - steps0.get("runs", 0)
    if ran != prefills:
        raise AssertionError(f"the registry ran serve.prefill {ran} times; the warm-ups' {warm} "
                             f"and {repeats} replays of {n} requests make {prefills} prefills")
    captures = steps.get("captures", 0) - steps0.get("captures", 0)
    timed = {mode: res["scenarios"]["heavy_tail"][mode]["captures"] for mode in ("gang",
                                                                            "continuous")}
    if any(any(c) for c in timed.values()):
        raise AssertionError(f"a timed replay captured graphs: {timed}; every program a timed "
                             "replay runs must be captured in the warm-ups")
    return {"res": res, "rows": rows, "launches": launches, "prefills": prefills,
            "captures": captures, "timed_captures": timed}


def phase_serve_bench(device, card: str, serve: dict) -> dict:
    """The serve benchmark twin at full-width OLMo-1B (bf16, capacity 2048),
    heavy tail only, 5 repeats a scheduler after a warm-up, records into a
    temporary trajectory; then one more continuous replay (on the serve
    phase's weights) under the profiler, device activity only, for the
    device's idle share."""
    import tempfile

    from repro_torch.bench import serve_scenarios as twin
    from repro_torch.configs import get_config
    from repro_torch.runtime import traffic

    t0 = time.perf_counter()
    cfg = get_config("olmo-1b")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trajectory_") as tmp:
        out = serve_bench_path(device, capacity=2048, repeats=5,
                               trajectory=Path(tmp) / "trajectory.jsonl")
    res, row = out["res"], out["res"]["scenarios"]["heavy_tail"]
    want = _expected_launches(cfg, out["prefills"] + out["captures"])
    if out["launches"] != want:
        raise AssertionError(f"serve-bench launches {out['launches']}, expected {want} = "
                             f"({out['prefills']} prefills + {out['captures']} captures) x "
                             f"{cfg.n_layers} layers")
    print(f"serve-bench: repro_torch.bench.serve_scenarios, {cfg.name} full width, bf16, "
          f"capacity 2048, heavy_tail ({row['n_requests']} requests, seed 7 + 17), settings "
          f"{res['settings']}, 1 warm-up + {res['repeats']} repeats per scheduler, on {card}")
    for mode in ("gang", "continuous"):
        m = row[mode]
        print(f"serve-bench: {mode:10s} median tokens_per_s {np.median(m['tokens_per_s']):.2f}, "
              f"p50_latency_s {np.median(m['p50_latency_s']):.4f}, p99_latency_s "
              f"{np.median(m['p99_latency_s']):.4f} (samples {[round(v, 2) for v in m['tokens_per_s']]}); "
              f"{int(m['total_tokens'])} tokens")
    v = res["heavy_tail_verdict"]
    print(f"serve-bench: continuous vs gang: {v['verdict']} (effect {v['effect']:+.3f}, p "
          f"{v['p_value']}) -- printed, not gated; equal token totals gated; the twin's "
          f"wall {res['wall_s']:.1f} s")
    print(f"serve-bench: {len(out['rows'])} records appended to a temporary trajectory; "
          f"launches {out['launches']} (= ({out['prefills']} prefills + {out['captures']} "
          f"prefill captures) x {cfg.n_layers} layers); graph captures / replays: warm-ups "
          f"{res['warmup_graphs']}, each timed replay {out['timed_captures']} captures (gated: "
          f"none) and {[row[m]['replays'] for m in ('gang', 'continuous')]} replays")

    arrivals = twin.scenario_arrivals(7, quick=False)["heavy_tail"]
    n0 = {name: fn.launches for name, fn in _kernels().items()}
    t1 = time.perf_counter()
    found = _device_profile(lambda: (traffic.replay(twin._server(serve["params"], cfg,
                                                                 "continuous", 2048, device),
                                                    arrivals),
                                     torch.cuda.synchronize()), host=False)
    for name, fn in _kernels().items():              # the profiled replay is not counted
        fn.launches = n0[name]
    if found is None:
        print("serve-bench: the profiler recorded no device activity")
    else:
        busy, window, n_ops, _ = found
        print(f"serve-bench: continuous replay under torch.profiler (device activity only, "
              f"{time.perf_counter() - t1:.1f} s): device busy {busy / 1e3:.1f} ms of a "
              f"{window / 1e3:.1f} ms window (idle share {1 - busy / window:.3f}), "
              f"{n_ops} device ops")
    print(f"serve-bench: phase wall {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------- serving-grid
def instance_settings(component: str, workload: str) -> dict:
    """What the component's running instance (the module's settings object
    the runtime reads: the server's, the checkpoint writer's, the
    pipeline's) resolves for ``workload``: its explicit keys, then the
    store, then the declared defaults."""
    from repro_torch.core import configstore, registry

    return registry.settings_for(configstore.Context(component, workload))


def new_instance_settings(component: str, workload: str) -> dict:
    """What a new instance with no keys of its own resolves for
    ``workload``: the store, then the declared defaults.  For components
    that are built anew with their settings as keys (the demo grid's hash
    tables and spinlocks: every evaluation builds one with the proposal)."""
    from repro_torch.core import configstore, registry

    space = registry.get_component(component).space
    return space.validate(configstore.resolve_settings(component, workload,
                                                       defaults=space.defaults(), space=space))


def grid_path(device, grid: str, *, budget: int, campaign_id: str, resolve) -> dict:
    """A named campaign grid into a temporary store and journal (the default
    store for the path), then again under the same id.  Raises unless every
    cell is done, every entry is filed under this process's hardware and
    software, every promoted cell's best is what ``resolve(component,
    workload)`` gives (:func:`instance_settings` or
    :func:`new_instance_settings`: what the component runs with), and the
    rerun measures nothing.  The kernels' launch counts are zeroed before
    the first run and read after it."""
    import tempfile

    from repro_torch.core import configstore
    from repro_torch.launch import campaign as launch

    kernels = _kernels()
    hw, sw = configstore.hardware_fingerprint(), configstore.sw_fingerprint()
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{grid}_") as tmp:
        store = configstore.ConfigStore(Path(tmp) / "store")
        old = configstore.set_default_store(store)
        try:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            for fn in kernels.values():              # counts of this path only
                fn.launches = 0
            t0 = time.perf_counter()
            camp, results = launch.run_grid(grid, budget=budget, optimizer="bo", seed=0,
                                            device=device, campaign_id=campaign_id, store=store,
                                            journal_root=Path(tmp) / "journal")
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in kernels.items()}
            cell_ids = {c.cell_id for c in camp.cells}
            want = sum(len(w) for w in launch.GRIDS[grid].values())
            if len(cell_ids) != want or set(camp.journal.completed()) != cell_ids:
                raise AssertionError(f"{grid}: cells without a cell_done row: "
                                     f"{sorted(cell_ids - set(camp.journal.completed()))}")
            entries = []
            for comp in launch.GRIDS[grid]:
                path = store.root / f"{comp}.json"
                entries += json.loads(path.read_text())["entries"] if path.exists() else []
            for e in entries:
                if e["context"]["hardware"] != hw or e["context"]["sw"] != sw:
                    raise AssertionError(f"entry filed under {e['context']}, not {hw} / {sw}")
            for r in results.values():
                got = resolve(r.cell.component, r.cell.workload)
                if r.promoted and got != r.best_config:
                    raise AssertionError(f"{r.cell.cell_id}: settings_for gives {got}, "
                                         f"promoted {r.best_config}")
            again, res2 = launch.run_grid(grid, budget=budget, optimizer="bo", seed=0,
                                          device=device, campaign_id=campaign_id, store=store,
                                          journal_root=Path(tmp) / "journal")
            if again.measure_calls != 0 or not all(r.resumed for r in res2.values()):
                raise AssertionError(f"{grid}: resume re-measured: {again.measure_calls} calls")
        finally:
            configstore.set_default_store(old)
    return {"results": results, "measure_calls": camp.measure_calls, "entries": len(entries),
            "hardware": hw, "wall_s": wall, "launches": launches}


def phase_grid(device, card: str, grid: str, *, budget: int, label: str) -> dict:
    """A campaign grid of settings objects the runtime reads on the card
    through :func:`grid_path` (each promoted best resolved through the
    running instance), printed."""
    from repro_torch.launch import campaign as launch

    out = grid_path(device, grid, budget=budget, campaign_id=f"chip-smoke-{grid}",
                    resolve=instance_settings)
    print(f"{label}: the {grid} grid, {len(out['results'])} cells, bo budget {budget}, "
          f"{out['measure_calls']} measurements, wall {out['wall_s']:.1f} s, on {card}")
    for _, r in sorted(out["results"].items()):
        print(f"{label}: " + launch.describe(r))
    print(f"{label}: {out['entries']} entries filed under {out['hardware']}; launches "
          f"{out['launches']}; a rerun under the same id measured nothing")
    return out


def phase_serving_grid(device, card: str) -> dict:
    """The ``serving`` grid on the card (reduced OLMo-1B, bf16, budget 3);
    the grid must launch the attention kernel."""
    t0 = time.perf_counter()
    out = phase_grid(device, card, "serving", budget=3, label="serving-grid")
    if not out["launches"]["flash_attention"]:
        raise AssertionError(f"the serving grid launched no attention kernel: {out['launches']}")
    print(f"serving-grid: phase wall {time.perf_counter() - t0:.1f} s")
    return out


def phase_training_grid(device, card: str) -> dict:
    """The ``training`` grid (reduced OLMo-1B in bf16: the checkpoint
    policy at its state bucket kb2048, the input pipeline at b4s128 and
    b8s256; bo budget 4) in the train phase's process, on the card; its
    checkpoint cells train, so the grid must launch the attention kernel."""
    t0 = time.perf_counter()
    out = phase_grid(device, card, "training", budget=4, label="training-grid")
    if not out["launches"]["flash_attention"]:
        raise AssertionError(f"the training grid launched no attention kernel: "
                             f"{out['launches']}")
    print(f"training-grid: phase wall {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------------ figures
def figures_path(device, out_dir, *, budget: Optional[int] = None) -> dict:
    """The paper's Figures 3-5 through the port's twins (``bench/fig3_hashtable``,
    ``fig4_counters``, ``fig5_spinlock``; fig3's and fig5's BO arms on the torch
    GP engine on ``device``), written under ``out_dir``, then the ``demo``
    campaign grid with every BO on the engine.  Raises unless every instance x
    optimizer of fig3 has a trace of ``budget`` best-so-far values that never
    rise and a verdict, fig4 has a row per size of its sweep whose collisions
    never rise, fig5 has a best spin for each workload, and the grid passes
    :func:`grid_path`'s gates."""
    from repro_torch.bench import fig3_hashtable as fig3
    from repro_torch.bench import fig4_counters as fig4
    from repro_torch.bench import fig5_spinlock as fig5
    from repro_torch.core.optimizers import optimizer_defaults, set_optimizer_defaults
    from repro_torch.core.tracking import Tracker

    budget = fig3.BUDGET if budget is None else budget
    dev = str(torch.device(device))
    walls = {}
    t0 = time.perf_counter()
    f3 = fig3.write(fig3.run(Tracker(Path(out_dir) / "runs"), budget, backend="torch",
                             device=dev), out_dir, backend="torch", device=dev)
    walls["fig3"] = time.perf_counter() - t0
    for inst in fig3.INSTANCES:
        for opt in fig3.OPTIMIZERS:
            trace = f3[inst]["traces"][opt]
            if len(trace) != budget or any(b > a for a, b in zip(trace, trace[1:])):
                raise AssertionError(f"fig3 {inst} {opt}: trace {trace} (budget {budget})")
            if f3[inst]["best"][opt]["verdict"] not in ("improved", "regressed", "noise"):
                raise AssertionError(f"fig3 {inst} {opt}: no verdict: {f3[inst]['best'][opt]}")
    t0 = time.perf_counter()
    f4 = fig4.write(fig4.run(), out_dir)
    walls["fig4"] = time.perf_counter() - t0
    coll = [r["collisions"] for r in f4["rows"]]
    if [r["log2_buckets"] for r in f4["rows"]] != fig4.SWEEP or \
            any(b > a for a, b in zip(coll, coll[1:])):
        raise AssertionError(f"fig4 rows {[r['log2_buckets'] for r in f4['rows']]}, "
                             f"collisions {coll}")
    t0 = time.perf_counter()
    f5 = fig5.write(fig5.run(backend="torch", device=dev), out_dir, backend="torch",
                    device=dev)
    walls["fig5"] = time.perf_counter() - t0
    if set(f5["workloads"]) != {str(h) for h in fig5.HEAVY} or not all(
            r["best_spin_grid"] in fig5.GRID and r["best_spin_bo"] >= 1
            for r in f5["workloads"].values()):
        raise AssertionError(f"fig5: {f5['workloads']}")
    old = optimizer_defaults()
    set_optimizer_defaults(backend="torch", device=dev)
    try:
        demo = grid_path(device, "demo", budget=8, campaign_id="chip-smoke-demo",
                         resolve=new_instance_settings)
    finally:
        set_optimizer_defaults(**old)
    walls["demo"] = demo["wall_s"]
    return {"fig3": f3, "fig4": f4, "fig5": f5, "demo": demo, "walls": walls}


def claims(out: dict) -> list:
    """The paper's claims C1-C6 as the figures read them: printed, not
    gated, as the reference prints them."""
    f3, f4, f5 = out["fig3"], out["fig4"], out["fig5"]
    lines = []
    for inst, r in f3.items():
        b = r["best"]
        c1 = ", ".join(f"{o} {v['improvement_pct']:+.1f}% [{v['verdict']}]" for o, v in b.items())
        lines.append(f"C1 tuned vs default ({inst}, default {r['default_host_us']:.0f} host us): "
                     f"{c1}")
        bo = min(b["bo_rbf"]["host_us"], b["bo_matern32"]["host_us"])
        lines.append(f"C3 RS vs BO ({inst}): random {b['random']['host_us']:.0f} against the "
                     f"better BO {bo:.0f} host us (ratio {b['random']['host_us'] / bo:.3f})")
        multi = min(v["host_us"] for o, v in b.items() if o != "one_at_a_time")
        lines.append(f"C4 multi-parameter vs one-at-a-time ({inst}): {multi:.0f} against "
                     f"{b['one_at_a_time']['host_us']:.0f} host us")
    lines.append("C2 the surface differs across workloads: best configs " + "; ".join(
        f"{inst} {r['best']['bo_matern32']['config']}" for inst, r in f3.items()))
    s = f4["sweet_spot"]
    lines.append(f"C5 memory vs CPU: sweet spot 2^{s['log2_buckets']} ({s['memory_mb']:.2f} MB) "
                 f"against 2^{s['against_log2_buckets']}: {s['verdict']} "
                 f"(effect {100 * s['effect']:+.1f}%)")
    spins = {h: r["best_spin_grid"] for h, r in f5["workloads"].items()}
    lines.append(f"C6 the optimal spin shifts with the workload: best grid spin by heavy_ops "
                 f"{spins} (BO: {({h: r['best_spin_bo'] for h, r in f5['workloads'].items()})})")
    return lines


def phase_figures(device, card: str) -> dict:
    """Figures 3-5 and the ``demo`` grid on the card (:func:`figures_path`);
    the claims printed."""
    import tempfile

    from repro_torch.launch import campaign as launch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_figures_") as td:
        out = figures_path(device, td)
    for line in claims(out):
        print(f"figures: {line}")
    for _, r in sorted(out["demo"]["results"].items()):
        print("figures: demo grid: " + launch.describe(r))
    w = out["walls"]
    print(f"figures: host walls fig3 {w['fig3']:.1f} s, fig4 {w['fig4']:.1f} s, fig5 "
          f"{w['fig5']:.1f} s, demo grid {w['demo']:.1f} s ({out['demo']['measure_calls']} "
          f"measurements, {out['demo']['entries']} entries under {out['demo']['hardware']}, a "
          f"rerun measured nothing); BO on the torch engine on {card}")
    print(f"figures: phase wall {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------- cold-warm
def start_cold_warm() -> Background:
    """``python -m repro_torch.bench.runner --quick --only compile_cold_warm``
    on the card, in the background: its 13 children wait on their imports,
    on ``nvcc`` and on each other, and the serving phases of the MoE and
    cross-attention models run beside them.  The runner holds the JSON to
    ``check_compile_cold_warm``."""
    return start_twin("compile_cold_warm", quick=True, timeout=600.0)


def phase_cold_warm(twin, card: str) -> dict:
    """The cold/warm twin on the card, read where it ends: 6 cold children,
    each building into an empty kernel root of its own, against 6 warm ones
    on a root one unmeasured child primed; the runner's
    ``check_compile_cold_warm`` gates it (a failing check fails the
    runner).  Every child must have launched the attention kernel (one
    train step, the model's layers x 2) and every cold child must have built
    a library."""
    try:
        waited = twin.finish("cold-warm")
        res = json.loads((twin.dir / "compile_cold_warm.json").read_text())
    finally:
        twin.stop()
    v = res["verdict"]
    if not res["roots_removed"]:
        raise AssertionError("the twin left its temporary kernel roots behind")
    if not all(n > 0 for n in res["launches"]):
        raise AssertionError(f"a child launched no attention kernel: {res['launches']}")
    if any(res["cold_libraries"][i] == [] for i in range(len(res["cold_s"]))):
        raise AssertionError(f"a cold child built nothing: {res['cold_libraries']}")
    print(f"cold-warm: first step cold {[round(s, 3) for s in res['cold_s']]} s, warm "
          f"{[round(s, 3) for s in res['warm_s']]} s (priming {res['priming_s']:.3f} s, not "
          f"counted); median {np.median(res['cold_s']):.3f} -> {np.median(res['warm_s']):.3f} s, "
          f"{v['verdict']} (effect {v['effect']:+.3f}, p {v['p_value']}); each cold child built "
          f"{res['cold_libraries'][0]}; counters {res['counters']}; launches per child "
          f"{res['launches']}; {len(res['launches'])} children in {res['wall_s']:.1f} s ({card})")
    print(f"cold-warm: ran {time.perf_counter() - twin.t0:.1f} s beside the serving phases of "
          f"the MoE and cross-attention models; waited {waited:.1f} s for it at its end")
    return {**res, "path_launches": {"flash_attention": sum(res["launches"]), "ssd": 0,
                                     "rmsnorm": 0}}


# ----------------------------------------------------------------- examples
EXAMPLES = ("quickstart", "train_lm", "train_lm-mamba2", "serve_decode", "autotune_kernels",
            "campaign_quickstart")


def examples_path(device, tmp) -> dict:
    """Each of the port's examples (``repro_torch.examples``) through its
    ``main`` at its smoke size on ``device``, the kernels' launch counts
    zeroed before each and read after it.  Raises unless every loss is finite,
    the train examples launch each kernel of their family steps x layers x
    (1 + recompute) times on the card, every serve trial produced tokens,
    the spawned agent's session report arrived and its process exited 0,
    the campaign's resume measured nothing and its warm start reached the
    cell's best in fewer evaluations than the same cell cold."""
    from repro_torch.configs import get_config
    from repro_torch.examples import (autotune_kernels, campaign_quickstart, quickstart,
                                      serve_decode, train_lm)

    dev = str(torch.device(device))
    tmp = Path(tmp)
    kernels = _kernels()
    runs = {
        "quickstart": (quickstart.main, []),
        "train_lm": (train_lm.main, ["--ckpt-dir", str(tmp / "train_lm")]),
        "train_lm-mamba2": (train_lm.main, ["--arch", "mamba2-780m",
                                            "--ckpt-dir", str(tmp / "train_lm_mamba2")]),
        "serve_decode": (serve_decode.main, []),
        "autotune_kernels": (autotune_kernels.main, []),
        "campaign_quickstart": (campaign_quickstart.main,
                                ["--store", str(tmp / "store"),
                                 "--journal-root", str(tmp / "campaign")]),
    }
    out = {}
    for name, (main, argv) in runs.items():
        if dev.startswith("cuda"):
            torch.cuda.synchronize()
        for fn in kernels.values():                  # counts of this example only
            fn.launches = 0
        t0 = time.perf_counter()
        res = main(["--device", dev, *argv])
        if dev.startswith("cuda"):
            torch.cuda.synchronize()
        out[name] = {"result": res, "wall_s": time.perf_counter() - t0,
                     "launches": {k: fn.launches for k, fn in kernels.items()}}

    for name, arch, steps in (("quickstart", "olmo-1b", quickstart.STEPS),
                              ("train_lm", "olmo-1b", 20), ("train_lm-mamba2", "mamba2-780m", 20)):
        res, launches = out[name]["result"], out[name]["launches"]
        if len(res["losses"]) != steps or not all(math.isfinite(x) for x in res["losses"]):
            raise AssertionError(f"{name}: losses {res['losses']}")
        cfg = get_config(arch).reduced().validate()
        per_step = _expected_launches(cfg, _remat_factor(cfg, 8, 64))
        want = ({k: v * steps for k, v in per_step.items()} if dev.startswith("cuda")
                else dict.fromkeys(kernels, 0))      # a CPU tensor never reaches a kernel
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected {want}")
    sd = out["serve_decode"]
    if not all(t["tokens"] > 0 and t["tokens_per_s"] > 0 for t in sd["result"]["trials"]):
        raise AssertionError(f"serve_decode: {sd['result']['trials']}")
    at = out["autotune_kernels"]["result"]
    if at["report"] is None or at["agent_exitcode"] != 0 or \
            at["report"]["best_config"] != at["settings"]:
        raise AssertionError(f"autotune_kernels: report {at['report']}, agent exit code "
                             f"{at['agent_exitcode']}, settings {at['settings']}")
    cq = out["campaign_quickstart"]["result"]
    if cq["resume_measure_calls"] != 0 or cq["warm_start"] is None or \
            cq["warm_evals"] is None or cq["cold_evals"] is None or \
            not cq["warm_evals"] < cq["cold_evals"]:
        raise AssertionError(f"campaign_quickstart: resume measured {cq['resume_measure_calls']}, "
                             f"warm start {cq['warm_start']}, evals warm {cq['warm_evals']} "
                             f"cold {cq['cold_evals']}")
    if dev.startswith("cuda"):
        for name in ("serve_decode", "autotune_kernels"):
            if not out[name]["launches"]["flash_attention"]:
                raise AssertionError(f"{name} launched no attention kernel: "
                                     f"{out[name]['launches']}")
    return out


def phase_examples(device, card: str) -> dict:
    """The five examples at their smoke sizes on the card (:func:`examples_path`)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as td:
        out = examples_path(device, td)
    for name, o in out.items():
        r = o["result"]
        if "losses" in r:
            what = f"loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} over {len(r['losses'])} steps"
        elif name == "serve_decode":
            what = (f"trials {[(t['max_batch'], round(t['tokens_per_s'], 1)) for t in r['trials']]}"
                    f" (max_batch, host tokens/s); best {r['best_config']}; prefills + captures "
                    f"{sum(t['prefills'] + t['prefill_captures'] for t in r['trials'])}")
        elif name == "autotune_kernels":
            what = (f"default {r['default_us']:.1f} us -> tuned {r['tuned_us']:.1f} us at "
                    f"{r['settings']}; the daemon's report after {r['report']['evaluations']} "
                    f"evaluations; daemon exit code {r['agent_exitcode']}")
        else:
            what = (f"resume measured {r['resume_measure_calls']}; {r['warm_evals']} evaluations "
                    f"warm against {r['cold_evals']} cold to within 10% of {r['target']:.0f} "
                    f"collisions")
        print(f"examples: {name}: {what}; wall {o['wall_s']:.1f} s, launches {o['launches']} "
              f"({card})")
    print(f"examples: phase wall {time.perf_counter() - t0:.1f} s")
    return out


# -------------------------------------------------------------------- train
class _StepTimer:
    """CUDA events around every step of ``run_training``: ``on_step(step,
    ckpt_dir)`` is called at the top of a step (the loop's chaos hook, with
    no fault plan), ``__call__(step, metrics)`` after its metrics are read.
    On the CPU the host clock takes their place."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.rows, self._start = [], None

    def on_step(self, step, ckpt_dir=None):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def __call__(self, step, metrics):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            ms = self._start.elapsed_time(end)
        else:
            ms = 1e3 * (time.perf_counter() - self._start)
        self.rows.append({"step": step, "loss": metrics["loss"],
                          "grad_norm": metrics["grad_norm"], "lr": metrics["lr"], "ms": ms})


def train_flops(cfg, batch: int, seq: int, frames: int = 0) -> float:
    """Model FLOPs of one train step (the MFU reading's numerator): 6·N per
    token for the parameters' products (forward and backward, no recompute;
    N the active parameters: a MoE token runs top-k of its experts; an
    encoder-decoder's encoder runs on ``frames`` frames a row, counted here
    as if they were as many as the tokens) plus attention's 12·S_k·H·D per
    query and layer: causal self-attention's halved by the mask, an
    encoder's over its frames, cross-attention's over the source (frames,
    or a VLM's modal tokens)."""
    tokens = batch * seq
    hd = 12.0 * cfg.n_heads * cfg.hd
    causal = cfg.n_layers if cfg.family in ("dense", "moe", "hybrid", "encdec", "vlm") else 0
    attn = hd * causal * tokens * seq / 2
    if cfg.family == "encdec":
        attn += hd * (cfg.enc_layers * batch * frames * frames + cfg.n_layers * tokens * frames)
    if cfg.family == "vlm":
        attn += hd * (cfg.n_layers // cfg.cross_attn_period) * tokens * cfg.num_modal_tokens
    return 6.0 * cfg.active_param_count() * tokens + attn


def _remat_factor(cfg, batch: int, seq: int) -> int:
    """Launches of each kernel per layer and step: 1, and 1 more when the
    resolved ``remat`` recomputes the layer in the backward pass."""
    from repro_torch.models.transformer import stack_settings, stack_workload

    remat = stack_settings.settings_for(stack_workload(cfg.family, batch, seq,
                                                       cfg.n_layers))["remat"]
    return 1 + (remat != "none")


def train_main_path(device, cfg, *, batch: int, seq: int, steps: int, resume_to: int,
                    ckpt_every: int, ckpt_dir, ckpt_overrides=None,
                    continued: bool = False) -> dict:
    """``run_training`` for ``steps`` steps with a checkpoint every
    ``ckpt_every`` into ``ckpt_dir``, then again to ``resume_to`` steps,
    which must resume where the first run stopped.  The kernels' launch
    counts are zeroed before each run and read after it; each run must
    launch every kernel of the family layers × (1 + recompute) times a
    step (none on the CPU), and every loss must be finite.  With
    ``continued``, the first run's final state also steps on in memory to
    ``resume_to`` (no save, no restore; the loop's batches and
    ``lr_scale``): ``out["continued"]`` holds those steps' metrics, to set
    beside the resumed run's."""
    from repro_torch.data.pipeline import PackedBatcher, SyntheticCorpus
    from repro_torch.runtime.steps import train_step_for
    from repro_torch.runtime.train_loop import run_training, train_settings, workload_signature

    device = torch.device(device)
    kernels = _kernels()
    per_step = _expected_launches(cfg, _remat_factor(cfg, batch, seq))
    runs, first_state = [], None
    for n_steps in (steps, resume_to):
        timer = _StepTimer(device)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():                  # counts of this run only
            fn.launches = 0
        t0 = time.perf_counter()
        out = run_training(cfg, n_steps=n_steps, global_batch=batch, seq_len=seq,
                           ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
                           ckpt_overrides=ckpt_overrides, on_step=timer, chaos=timer, seed=0,
                           device=device)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        done = [r["step"] for r in timer.rows]
        expected = ({k: v * len(done) for k, v in per_step.items()} if device.type == "cuda"
                    else dict.fromkeys(kernels, 0))  # a CPU tensor never reaches a kernel
        if launches != expected:
            raise AssertionError(f"train launches {launches} over {len(done)} steps; expected "
                                 f"{expected}")
        if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                   for r in timer.rows):
            raise AssertionError(f"a non-finite loss or gradient norm: {timer.rows}")
        runs.append({"rows": timer.rows, "launches": launches, "wall_s": wall,
                     "ckpt": out["ckpt_counters"], "data": out["data_counters"],
                     "peak_bytes": (torch.cuda.max_memory_allocated()
                                    if device.type == "cuda" else 0)})
        if continued and first_state is None:
            first_state = out["state"]
        del out
    rows = []
    if continued:
        step_fn = train_step_for(cfg)
        data = PackedBatcher(SyntheticCorpus(cfg.vocab_size, seed=0), batch, seq)
        scale = float(train_settings.settings_for(
            workload_signature(batch, seq, cfg.d_model))["lr_scale"])
        for step in range(steps, resume_to):
            b = {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
                 for k, v in data.batch_at(step).items()}
            first_state, m = step_fn(first_state, b, scale)
            rows.append({"step": step, **{k: float(v) for k, v in m.items()}})
        del first_state
    first, second = ([r["step"] for r in run["rows"]] for run in runs)
    if first != list(range(steps)) or second != list(range(steps, resume_to)):
        raise AssertionError(f"steps {first} then {second}: the second run must resume at "
                             f"step {steps}")
    return {"runs": runs, "launches": {k: sum(r["launches"][k] for r in runs)
                                       for k in kernels}, "continued": rows}


def _train_report(label: str, cfg, batch: int, seq: int, out: dict, card: str) -> None:
    flops = train_flops(cfg, batch, seq)
    for i, run in enumerate(out["runs"]):
        for r in run["rows"]:
            print(f"{label}: step {r['step']}: loss {r['loss']:.4f}, grad_norm "
                  f"{r['grad_norm']:.4g}, lr {r['lr']:.3g}, {r['ms']:.1f} ms by CUDA events, "
                  f"{batch * seq / (r['ms'] / 1e3):.0f} tokens/s, MFU reading "
                  f"{flops / (r['ms'] / 1e3) / PEAK_BF16_FLOPS:.3f} ({card})")
        c = run["ckpt"]
        print(f"{label}: run {i + 1}: wall {run['wall_s']:.1f} s, peak memory allocated "
              f"{run['peak_bytes'] / 2**30:.2f} GiB, {int(c['saves'])} checkpoint saves, "
              f"checkpoint blocked {c['blocked_s']:.2f} s, data stall {run['data']['stall_s']:.3f} "
              f"s, launches {run['launches']} ({card})")
    steady = [r["ms"] for run in out["runs"] for r in run["rows"][1:]]
    if steady:
        ms = float(np.median(steady))
        print(f"{label}: median step after the first of each run {ms:.1f} ms, "
              f"{batch * seq / (ms / 1e3):.0f} tokens/s, MFU reading "
              f"{flops / (ms / 1e3) / PEAK_BF16_FLOPS:.3f} of {PEAK_BF16_FLOPS / 1e12:.0f} "
              f"TFLOP/s ({flops / 1e12:.2f} TFLOP a step) ({card})")


def phase_train(device, card: str, name: str = "olmo-1b", batch: int = 8, seq: int = 2048,
                steps: int = 6, resume_to: int = 8, ckpt_every: int = 3,
                label: str = "train", continued: bool = False) -> dict:
    """Full-width training through ``run_training`` (random bf16 weights from
    seed 0, the port's synthetic corpus): ``steps`` steps with a checkpoint
    every ``ckpt_every`` into a temporary directory, then a second run to
    ``resume_to`` steps that must resume at ``steps``.  With ``continued``
    the resumed steps' gradient norms and losses are printed in full beside
    those of the first run continued in memory (printed, not gated)."""
    import tempfile

    from repro_torch.configs import get_config

    cfg = get_config(name)
    t0 = time.perf_counter()
    print(f"{label}: {name} full width ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f} B params, {cfg.dtype}), batch {batch} x seq {seq}, "
          f"{steps} steps then resume to {resume_to}, checkpoint every {ckpt_every} on {card}")
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{label}_") as td:
        out = train_main_path(device, cfg, batch=batch, seq=seq, steps=steps,
                              resume_to=resume_to, ckpt_every=ckpt_every, ckpt_dir=td,
                              continued=continued)
    _train_report(label, cfg, batch, seq, out, card)
    resumed = {r["step"]: r for r in out["runs"][1]["rows"]}
    for r in out["continued"]:
        back = resumed[r["step"]]
        same = (back["grad_norm"], back["loss"]) == (r["grad_norm"], r["loss"])
        print(f"{label}: step {r['step']}: grad_norm resumed {back['grad_norm']!r}, continued "
              f"in memory {r['grad_norm']!r}; loss {back['loss']!r} / {r['loss']!r}: "
              f"{'the same bits' if same else 'DIFFERENT'}")
    print(f"{label}: the second run resumed at step {steps}; launches "
          f"{out['launches']} = steps x {cfg.n_layers} layers x "
          f"{_remat_factor(cfg, batch, seq)} (remat)")
    print(f"{label}: phase wall {time.perf_counter() - t0:.1f} s")
    return out


def phase_train_profile(device, card: str, name: str = "olmo-1b", batch: int = 8,
                        seq: int = 2048, top: int = 8) -> dict:
    """One warm train step of the train phase's shape again, by CUDA events
    and under torch.profiler (device activity only): the device's busy
    time and idle share over the step, and the kernels that take it."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.steps import init_train_state, train_step_for

    cfg = get_config(name)
    state = init_train_state(cfg, torch.Generator(device=device).manual_seed(0), device)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))).to(device)
    data = {"tokens": toks, "labels": toks.roll(-1, 1)}
    step = train_step_for(cfg)
    state, _ = step(state, data)                     # warm: cuBLAS, allocator
    ms = _time_ms(lambda: step(state, data), reps=1)
    busy, window, n_ops, by_name = _device_profile(lambda: (step(state, data),
                                                            torch.cuda.synchronize()), host=False)
    del state
    torch.cuda.empty_cache()
    print(f"train-profile: {name} batch {batch} x seq {seq}: a warm step {ms:.1f} ms by CUDA "
          f"events; device busy {busy / 1e3:.1f} ms of a {window / 1e3:.1f} ms window "
          f"(idle share {1 - busy / window:.3f}), {n_ops} device ops ({card})")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"train-profile:   {us / busy:.3f} of busy, {us / 1e3:8.1f} ms  {kname[:100]}")
    return {"ms": ms, "busy_ms": busy / 1e3, "window_ms": window / 1e3, "ops": n_ops}


# ---------------------------------------------------------------------- MoE
# moe-dispatch: OLMoE-1B-7B's token counts (B, S) at decode, prefill and train
MOE_DISPATCH_SHAPES = {"decode": (8, 1), "prefill": (1, 1024), "train": (4, 2048)}
MOE_CAPACITY_FACTORS = (1.0, 1.25, 2.0)


def moe_bound_ms(tokens: int, d: int, f: int, n_experts: int, touched: int, assignments: int,
                 elem_bytes: int, peak_flops: float) -> tuple:
    """Least time for a MoE layer's work on this run's routing: x read once
    and y written once, the router and the ``touched`` experts' three
    weights read once, against the router's product and 6·d·f FLOPs per
    (token, expert) assignment that the layer computes."""
    bytes_moved = elem_bytes * (2 * tokens * d + d * n_experts + 3 * touched * d * f)
    flops = 2.0 * tokens * d * n_experts + 6.0 * assignments * d * f
    t_bytes, t_flops = bytes_moved / PEAK_BYTES, flops / peak_flops
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def moe_dispatch_path(device, cfg, *, shapes=None, seed: int = SEED, timed: bool = True) -> dict:
    """``apply_moe`` of one layer of ``cfg`` (random weights from ``seed``,
    unit-normal inputs) at each of ``shapes``: every strategy's output
    finite and of x's shape, the capacity path equal to the dense oracle
    within the dtype's tolerance at a capacity where nothing drops
    (cf = E/k), the ``dropped_frac`` at ``MOE_CAPACITY_FACTORS``; on the
    card each strategy's ms by events and device-held, beside the bound."""
    from repro_torch.models import moe
    from repro_torch.models.layers import dtype_of, init_leaf

    device = torch.device(device)
    dtype = dtype_of(cfg)
    e, k, d, f = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model, cfg.moe_d_ff
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {name: init_leaf(gen, p, p.with_dtype(dtype), device)
              for name, p in moe.moe_params(cfg).items()}
    rows = {}
    for label, (b, s) in (shapes or MOE_DISPATCH_SHAPES).items():
        x = torch.randn((b, s, d), generator=gen, device=device).to(dtype)
        t = b * s
        dropped = {cf: float(moe.dropped_frac(params, x, cfg, capacity_factor=cf))
                   for cf in MOE_CAPACITY_FACTORS}
        with torch.no_grad():
            _, ids, _ = moe._route(params, x.reshape(t, d), cfg)
            want, _ = moe.apply_moe(params, x, cfg, strategy="dense")
            free, _ = moe.apply_moe(params, x, cfg, strategy="gather", capacity_factor=e / k)
        if float(moe.dropped_frac(params, x, cfg, capacity_factor=e / k)) != 0.0:
            raise AssertionError(f"{label}: assignments dropped at capacity factor E/k")
        tol = TOL[dtype]
        err = (free.float() - want.float()).abs()
        if (err > tol + tol * want.float().abs()).any():
            raise AssertionError(f"{label}: the capacity path without drops disagrees with the "
                                 f"dense oracle by {err.max().item():.3g} (tol {tol:.3g})")
        row = {"tokens": t, "dropped_frac": dropped, "oracle_max_abs_err": err.max().item(),
               "strategies": {}}
        cf = moe.moe_settings.settings_for(moe.workload_signature(t, e, k))["capacity_factor"]
        for strategy in moe.STRATEGIES:
            with torch.no_grad():
                y, aux = moe.apply_moe(params, x, cfg, strategy=strategy)
            if y.shape != x.shape or not torch.isfinite(y).all() or not torch.isfinite(aux):
                raise AssertionError(f"{label} {strategy}: y {tuple(y.shape)}, finite "
                                     f"{bool(torch.isfinite(y).all())}, aux {float(aux)}")
            if strategy == "dense":
                plan_ids = ids.reshape(-1)
            else:
                cap = moe.capacity(t, e, k, cf)
                flat, keep, _ = moe.dispatch_plan(ids, e, cap)
                plan_ids = flat[keep]                 # a host read: measurement only
            touched = int(torch.unique(plan_ids).numel())
            bound, by = moe_bound_ms(t, d, f, e, touched, int(plan_ids.numel()),
                                     dtype.itemsize, PEAK_BF16_FLOPS)
            r = {"bound_ms": bound, "bound_by": by, "experts_touched": touched,
                 "assignments": int(plan_ids.numel())}
            if timed and device.type == "cuda":
                with torch.no_grad():
                    r["ms"], r["ms_device"] = _both_ms(
                        lambda xx, st=strategy: moe.apply_moe(params, xx, cfg, strategy=st), x)
                    if strategy in ("gather", "dense"):
                        by_name = _kernels_us(lambda st=strategy: moe.apply_moe(
                            params, x, cfg, strategy=st), reps=5)
                        r["top_kernels"] = sorted(((us, n) for n, (us, _) in by_name.items()),
                                                  reverse=True)[:3]
            row["strategies"][strategy] = r
        rows[label] = row
    return rows


def phase_moe_dispatch(device, card: str) -> dict:
    """:func:`moe_dispatch_path` at full-width OLMoE-1B-7B on the card,
    with the three costliest kernels of the gather and dense strategies."""
    from repro_torch.configs import get_config

    cfg = get_config("olmoe-1b-7b")
    t0 = time.perf_counter()
    rows = moe_dispatch_path(device, cfg)
    for label, row in rows.items():
        t = row["tokens"]
        drops = ", ".join(f"cf {cf} {v:.4f}" for cf, v in row["dropped_frac"].items())
        print(f"moe-dispatch: {cfg.name} {label} T {t}: dropped_frac {drops}; gather at cf E/k "
              f"vs dense: max abs err {row['oracle_max_abs_err']:.3g} (tol {TOL[torch.bfloat16]:.3g})")
        for strategy, r in row["strategies"].items():
            print(f"moe-dispatch: {cfg.name} {label} T {t} {strategy}: events {r['ms']:.4f} / "
                  f"device-held {r['ms_device']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}; {r['assignments']} assignments to {r['experts_touched']} "
                  f"experts) ({card})")
            for us, kname in r.get("top_kernels", []):
                print(f"moe-dispatch:   {strategy} {us / 1e3:8.4f} ms a call  {kname[:90]}")
    print(f"moe-dispatch: phase wall {time.perf_counter() - t0:.1f} s")
    return rows


def train_twice_path(device, cfg, *, batch: int, seq: int, steps: int, seed: int = 0,
                     frames: int = 0, label: str = "train") -> dict:
    """``steps`` train steps of ``cfg`` from the seed's state on seeded
    batches (with ``frames`` seeded modal frames a row for encdec and vlm),
    twice: every step's loss and gradient norm and every leaf of the state
    after the last step must be the same bits in both runs (the kill →
    resume contract rests on it), every loss finite, and each run must
    launch every kernel of the family steps × attention calls × (1 +
    recompute) times (none on the CPU)."""
    from repro_torch.runtime.steps import init_train_state, train_step_for
    from repro_torch.tree import leaves_with_paths

    device = torch.device(device)
    kernels = _kernels()
    step = train_step_for(cfg)
    rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(steps):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))).to(device)
        batches.append({"tokens": toks, "labels": toks.roll(-1, 1)})
        if frames:
            batches[-1]["modal"] = torch.from_numpy(rng.standard_normal(
                (batch, frames, cfg.d_model)).astype(np.float32)).to(device)
    per_step = _expected_launches(cfg, _remat_factor(cfg, batch, seq))
    runs, first = [], None
    for _ in range(2):
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, torch.Generator(device=device).manual_seed(seed), device)
        for fn in kernels.values():
            fn.launches = 0
        timer = _StepTimer(device)
        for i, data in enumerate(batches):
            timer.on_step(i)
            state, m = step(state, data)
            timer(i, {k: float(v) for k, v in m.items()})
        launches = {name: fn.launches for name, fn in kernels.items()}
        expected = ({k: v * steps for k, v in per_step.items()} if device.type == "cuda"
                    else dict.fromkeys(kernels, 0))
        if launches != expected:
            raise AssertionError(f"{label} launches {launches}; expected {expected}")
        if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                   for r in timer.rows):
            raise AssertionError(f"a non-finite loss or gradient norm: {timer.rows}")
        runs.append({"rows": timer.rows, "launches": launches,
                     "peak_bytes": (torch.cuda.max_memory_allocated()
                                    if device.type == "cuda" else 0)})
        if first is None:
            first = state
            continue
        keys = ("loss", "grad_norm")
        if [[r[k] for k in keys] for r in runs[0]["rows"]] != \
                [[r[k] for k in keys] for r in runs[1]["rows"]]:
            raise AssertionError(f"two runs from one state differ: {runs[0]['rows']} against "
                                 f"{runs[1]['rows']}")
        differ = [path for (path, a), (_, b) in zip(leaves_with_paths(first),
                                                    leaves_with_paths(state))
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"two runs from one state end in different bits at {differ[:5]}")
    del first, state
    return {"runs": runs, "launches": {k: sum(r["launches"][k] for r in runs) for k in kernels}}


def phase_train_moe(device, card: str, batch: int = 4, seq: int = 2048, steps: int = 3,
                    n_layers: int = 2) -> dict:
    """Full-width OLMoE-1B-7B cut to ``n_layers`` layers: two bit-equal runs
    of ``steps`` steps; then reduced OLMoE-1B-7B through ``run_training``
    with a checkpoint and a resumed second run."""
    import tempfile

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    full = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(full, n_layers=n_layers).validate()
    print(f"train-moe: {full.name} full width, depth cut to {n_layers} of {full.n_layers} layers "
          f"({cfg.param_count() / 1e9:.3f} B params, {cfg.active_param_count() / 1e9:.3f} B "
          f"active, {cfg.dtype}), batch {batch} x seq {seq}, {steps} steps twice on {card}")
    out = train_twice_path(device, cfg, batch=batch, seq=seq, steps=steps, label="train-moe")
    flops = train_flops(cfg, batch, seq)
    for i, run in enumerate(out["runs"]):
        for r in run["rows"]:
            print(f"train-moe: run {i + 1} step {r['step']}: loss {r['loss']!r}, grad_norm "
                  f"{r['grad_norm']!r}, {r['ms']:.1f} ms by CUDA events, "
                  f"{batch * seq / (r['ms'] / 1e3):.0f} tokens/s, MFU reading "
                  f"{flops / (r['ms'] / 1e3) / PEAK_BF16_FLOPS:.3f} ({card})")
        print(f"train-moe: run {i + 1}: peak memory allocated {run['peak_bytes'] / 2**30:.2f} "
              f"GiB, launches {run['launches']}")
    print("train-moe: both runs gave the same bits: every loss, gradient norm and state leaf")
    small = get_config("olmoe-1b-7b").reduced()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_moe_") as td:
        resumed = train_main_path(device, small, batch=4, seq=64, steps=2, resume_to=3,
                                  ckpt_every=1, ckpt_dir=td)
    for i, run in enumerate(resumed["runs"]):
        steps_run = [(r["step"], round(r["loss"], 6)) for r in run["rows"]]
        print(f"train-moe: reduced {small.name} ({small.dtype}) run {i + 1}: (step, loss) "
              f"{steps_run}, {int(run['ckpt']['saves'])} checkpoint saves")
    print(f"train-moe: the reduced run resumed at step 2; phase wall "
          f"{time.perf_counter() - t0:.1f} s")
    return {"launches": {k: out["launches"][k] + resumed["launches"][k] for k in _kernels()}}


# ------------------------------------------------------- encoder-decoder, VLM
XATTN_NAMES = {"serve-encdec": "seamless-m4t-medium", "serve-vlm": "llama-3.2-vision-11b"}
XATTN_WEIGHT_SCALE = 0.3     # model-xattn: the reduced weights kept out of the chaotic regime


def xattn_reduced(name: str):
    """The reduced config model-xattn holds: seamless as ``reduced()``, the
    VLM with two groups (4 layers, ``cross_attn_period`` 2), so its group
    loop repeats."""
    from repro_torch.configs import get_config

    cfg = get_config(name).reduced()
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, n_layers=4)
    return cfg.validate()


def model_xattn_path(device, name: str, *, widths=(24, 2), steps: int = 3) -> dict:
    """A reduced encoder-decoder or VLM in float32 with seeded non-zero modal
    frames (the server's stub feeds zeros, under which a VLM's cross keys
    and values are 0): ``forward`` at width 24, ``prefill`` at each of
    ``widths`` and ``steps`` decode steps, on ``device`` (the card: the
    kernel path) against the CPU (the plain path).  The weights are drawn
    on the CPU from a seed, every matrix but the embedding scaled by
    ``XATTN_WEIGHT_SCALE`` (tests/torch_xattn.py's ``perturbed``: at the
    reduced init the hidden states reach O(20) and float32 rounding is
    amplified past the tolerance in either path).  Returns the worst
    absolute errors and the kernels' launches on ``device``."""
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map_with_path

    device = torch.device(device)
    cfg = xattn_reduced(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    params = tree_map_with_path(lambda path, t: t * XATTN_WEIGHT_SCALE
                                if t.dim() >= 2 and path != "embed" else t, params)
    n_frames = cfg.num_modal_tokens or XATTN_REDUCED_MODAL
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.standard_normal((2, n_frames, cfg.d_model)).astype(np.float32))
    toks = {w: torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, w))) for w in widths}
    fed = torch.from_numpy(rng.integers(2, cfg.vocab_size, (steps, 2)))

    def run(dev):
        p, f = _to(params, dev), frames.to(dev)
        outs = {"forward": [M.forward(p, cfg, toks[widths[0]].to(dev), f)[0]]}
        for w in widths:
            logits, caches, pos = M.prefill(p, cfg, toks[w].to(dev), 32, f)
            outs[f"prefill {w}"] = [logits]
            for tok in fed.to(dev):
                logits, caches = M.decode_step(p, cfg, tok, caches, pos)
                pos += 1
                outs[f"prefill {w}"].append(logits)
        return {k: [o.cpu() for o in v] for k, v in outs.items()}

    kernels = _kernels()
    for fn in kernels.values():
        fn.launches = 0
    got = run(device)
    launches = {k: fn.launches for k, fn in kernels.items()}
    want = run("cpu")
    errs = {}
    for key in got:
        for g, w in zip(got[key], want[key]):
            if not torch.isfinite(g).all():
                raise AssertionError(f"reduced {name}: non-finite outputs of {key}")
        errs[key] = max((g - w).abs().max().item() for g, w in zip(got[key], want[key]))
    return {"errs": errs, "launches": launches, "cfg": cfg, "frames": n_frames}


def phase_model_xattn(device, card: str) -> dict:
    """Both reduced families in float32, card against CPU (see
    :func:`model_xattn_path`), within the model phase's 1e-4."""
    t0 = time.perf_counter()
    launches = dict.fromkeys(_kernels(), 0)
    for name in XATTN_NAMES.values():
        out = model_xattn_path(device, name)
        worst = max(out["errs"].values())
        if worst > 1e-4 or not out["launches"]["flash_attention"]:
            raise AssertionError(f"reduced {name} on the card vs the CPU: errors {out['errs']}, "
                                 f"launches {out['launches']}")
        for k, n in out["launches"].items():
            launches[k] += n
        cfg = out["cfg"]
        print(f"model-xattn: reduced {name} ({cfg.family}, {cfg.n_layers} layers, "
              f"{out['frames']} seeded modal frames) f32, card (kernel path) vs CPU (plain "
              f"path): max abs err " + ", ".join(f"{k} {v:.3g}" for k, v in out["errs"].items())
              + f" (tol 1e-4); flash_attention launches {out['launches']['flash_attention']} "
              f"({card})")
    print(f"model-xattn: phase wall {time.perf_counter() - t0:.1f} s")
    return {"launches": launches}


def phase_train_encdec(device, card: str, batch: int = XATTN_TRAIN[0],
                       seq: int = XATTN_TRAIN[1], steps: int = 3) -> dict:
    """Full-width seamless-m4t-medium trained from the seed's state on
    ``batch`` x ``seq`` seeded tokens and as many seeded frames, ``steps``
    steps twice: the same bits in both runs (:func:`train_twice_path`);
    the gradients of the encoder's non-causal and the decoder's cross
    attention go through ``FlashAttentionFn``'s plain backward."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config("seamless-m4t-medium")
    print(f"train-encdec: {cfg.name} full size ({cfg.enc_layers} + {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.param_count() / 1e9:.3f} B params, {cfg.dtype}), batch {batch} "
          f"x seq {seq} with {seq} frames a row, {steps} steps twice on {card}")
    out = train_twice_path(device, cfg, batch=batch, seq=seq, steps=steps, frames=seq,
                           label="train-encdec")
    flops = train_flops(cfg, batch, seq, frames=seq)
    for i, run in enumerate(out["runs"]):
        for r in run["rows"]:
            print(f"train-encdec: run {i + 1} step {r['step']}: loss {r['loss']!r}, grad_norm "
                  f"{r['grad_norm']!r}, {r['ms']:.1f} ms by CUDA events, "
                  f"{batch * seq / (r['ms'] / 1e3):.0f} tokens/s, MFU reading "
                  f"{flops / (r['ms'] / 1e3) / PEAK_BF16_FLOPS:.3f} ({card})")
        print(f"train-encdec: run {i + 1}: peak memory allocated "
              f"{run['peak_bytes'] / 2**30:.2f} GiB, launches {run['launches']} (= steps x "
              f"{attention_passes(cfg)} attention calls x {_remat_factor(cfg, batch, seq)})")
    print("train-encdec: both runs gave the same bits: every loss, gradient norm and state leaf")
    print(f"train-encdec: phase wall {time.perf_counter() - t0:.1f} s")
    return out


# ----------------------------------------------------------------- train-grad
TRAIN_GRAD_SHAPES = {
    # name: (batch, seq, heads, kv_heads, head_dim) / (batch, seq, heads, head_dim, state, groups)
    "olmo-1b attention": (8, 2048, 16, 16, 128),
    "mamba2-780m ssd": (4, 1024, 48, 64, 128, 1),
}


def phase_train_grad(device) -> dict:
    """At the train phases' shapes, bf16 and float32: the outputs and input
    gradients through each kernel's autograd Function against autograd
    through its plain version alone, within the kernels phase's tolerances
    (tests/test_kernels.py's grid tolerances; the SSD's headroom 4)."""
    from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
    from repro_torch.kernels.ssd import kernel as sk, ref as sk_ref

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=device).manual_seed(SEED)
        b, s, h, kh, d = TRAIN_GRAD_SHAPES["olmo-1b attention"]
        q, k, v, do = (torch.randn(shape, generator=gen, device=device).to(dtype)
                       for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d)))
        ins = [t.requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention(*ins, causal=True)
        if out.grad_fn is None or type(out.grad_fn).__name__ != "FlashAttentionFnBackward":
            raise AssertionError(f"the attention kernel's output is not on its Function: "
                                 f"{out.grad_fn}")
        got = torch.autograd.grad(out, ins, do)
        want_out = fa_ref.naive_attention(*ins, causal=True)
        want = torch.autograd.grad(want_out, ins, do)
        errs[("attention", dtype)] = _grad_errs(out, want_out, got, want, "qkv", TOL[dtype])
        del q, k, v, do, ins, out, got, want_out, want
        b, s, h, p, n, g = TRAIN_GRAD_SHAPES["mamba2-780m ssd"]
        x, dt, A, B, C, D = _ssd_inputs((b, s, h, p, n, g), dtype, device, SEED)
        dy = torch.randn((b, s, h, p), generator=gen, device=device).to(dtype)
        ins = [t.clone().requires_grad_(True) for t in (x, dt, B, C)]
        y, state = sk.ssd(ins[0], ins[1], A, ins[2], ins[3], D, chunk=64, return_state=True)
        if type(y.grad_fn).__name__ != "SsdFnBackward" or state.grad_fn is None:
            raise AssertionError(f"the SSD kernel's outputs are not on its Function: "
                                 f"{y.grad_fn}, {state.grad_fn}")
        del state
        got = torch.autograd.grad(y, ins, dy)
        want_y = sk_ref.ssd_chunked(ins[0], ins[1], A, ins[2], ins[3], D, chunk=64)
        want = torch.autograd.grad(want_y, ins, dy)
        errs[("ssd", dtype)] = _grad_errs(y, want_y, got, want, ("x", "dt", "B", "C"),
                                          SSD_HEADROOM * TOL[dtype])
        del x, dt, A, B, C, D, dy, ins, y, got, want_y, want
        torch.cuda.empty_cache()
    shapes = dict(zip(("attention", "ssd"), TRAIN_GRAD_SHAPES.values()))
    for (kernel_name, dtype), e in errs.items():
        print(f"train-grad: {kernel_name} {str(dtype).split('.')[-1]} at {shapes[kernel_name]}: "
              + ", ".join(f"{k} max_abs_err {v:.3g}" for k, v in e.items()))
    return errs


# Whole-step gradients of the kernel's path against the plain path
# (``impl="naive"``) on the same weights and batch: the relative difference
# of the gradient norm, and of the worst leaf (the norm of its difference
# over its norm).  Held at the stack cut to 2 layers (full width, remat
# "full"), where the step is well conditioned: float32 within STEP_GRAD_TOL
# (the kernel agrees with its plain version to ~1e-6, so 1e-4 on the norm
# and 1e-3 on a leaf are wide for rounding and 1000x below a detached
# attention, whose leaves read 1.0).  At full depth the step at these
# weights is chaotic: its norm grows ~5x a layer
# (tests/test_torch_train.py::test_initial_grad_norm_matches_reference_at_
# depth), and a perturbation of the attention outputs at the size of one
# float32 rounding decorrelates its gradient.  There float32 is
# held to the plain path with its attention outputs off by the kernel's own
# float32 error (a relative +-eps, a fixed function of each output, so the
# recompute repeats it), over STEP_GRAD_DRAWS such perturbations: the
# kernel's loss may move by 4x their largest move, its worst leaf by 4x
# theirs, and its norm may lie within half their least and twice their
# largest (the norm is heavy-tailed under them; the phase prints each
# draw).  bfloat16, at both depths:
# one rounding of the attention output moves the attention weights'
# gradients by tens of percents, so both bf16 paths are held to the float32
# plain gradient: the kernel's error may be 2x the bf16 plain path's (on
# the worst leaf and on the norm) or STEP_GRAD_TOL, whichever is larger.
STEP_GRAD_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (5e-2, 0.25)}
STEP_GRAD_DRAWS = (12345.678, 54321.123, 1000.5, 2000.25)   # the perturbations' sign frequencies


class _PerturbedAttention:
    """Within the block, every attention output ``y`` becomes ``y * (1 +
    eps * sign(sin(freq * y)))``: off by a relative ``eps`` whose sign is a
    fixed function of the value, so a layer's recompute in the backward
    pass repeats its forward."""

    def __init__(self, eps: float, freq: float):
        self.eps, self.freq = eps, freq

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops

        self.ops, self.orig = ops, ops.flash_attention
        eps, freq, orig = self.eps, self.freq, self.orig

        def perturbed(*args, **kwargs):
            y = orig(*args, **kwargs)
            return y * (1 + eps * torch.sign(torch.sin(freq * y.float()))).to(y.dtype)

        ops.flash_attention = perturbed
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.orig


def _step_grads(cfg, params: dict, batch: dict, impl: str) -> tuple:
    """(loss, {leaf path: gradient}) of the train loss at ``params`` with the
    attention's ``impl`` pinned for the batch's workload."""
    from repro_torch.core import configstore
    from repro_torch.kernels.flash_attention.ops import workload_signature
    from repro_torch.models import model as M
    from repro_torch.runtime.steps import cast_for_compute
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    b, s = batch["tokens"].shape
    wl = workload_signature(b, s, s, cfg.hd)
    configstore.set_override("torch_flash_attention", wl, {"impl": impl})
    try:
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = M.loss_fn(cast_for_compute(live, cfg), cfg, batch)
        grads = torch.autograd.grad(loss, leaves(live))
    finally:
        configstore.clear_override("torch_flash_attention", wl)
    return float(loss.detach()), dict(zip((k for k, _ in leaves_with_paths(params)), grads))


def _norms(grads: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(g.float())) for k, g in grads.items()}


def _total(norms: dict) -> float:
    return math.sqrt(sum(n * n for n in norms.values()))


def _grad_diff(got: dict, want: dict) -> tuple:
    """(norm rel diff, {leaf: rel diff}) of two gradient trees."""
    gn, wn = _norms(got), _norms(want)
    leaf = {k: float(torch.linalg.vector_norm((got[k] - want[k]).float())) / max(wn[k], 1e-30)
            for k in got}
    return abs(_total(gn) - _total(wn)) / _total(wn), leaf


def phase_train_step_grad(device, card: str, cfg=None, batch: int = 8, seq: int = 2048,
                          depths=(2, 4, 8), eps: float = 2.0 ** -23) -> dict:
    """Whole-step gradients of ``cfg`` (full-width OLMo-1B unless given) on
    its seed-0 weights and the corpus's first batch, bf16 and float32: the
    kernel's path against the plain path at ``depths[0]`` layers and at
    full depth (``STEP_GRAD_TOL``; ``eps`` is the float32 kernel's error,
    the full-depth yardstick's perturbation); then the norm at the other
    cut depths and over the first 8 batches (the largest leaf and embedding
    rows of each), bf16 on the kernel's path."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PackedBatcher, SyntheticCorpus
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg = cfg or get_config("olmo-1b")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    corpus = PackedBatcher(SyntheticCorpus(cfg.vocab_size, seed=0), batch, seq)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
                for k, v in corpus.batch_at(i).items()}

    def cut(tree, n_layers):
        return {**tree, "blocks": tree["blocks"][:n_layers]}

    data, out, failed = batch_at(0), {}, []

    def report(n_layers, dtype, k_loss, k_norms, norm_rel, leaf_rel, base, tol_norm, tol_leaf):
        worst = max(leaf_rel, key=leaf_rel.get)
        tol_leaf = max(tol_leaf[worst], STEP_GRAD_TOL[dtype][1])
        tol_norm = max(tol_norm, STEP_GRAD_TOL[dtype][0])
        kn = _total(k_norms)
        top = sorted(k_norms, key=k_norms.get, reverse=True)[:3]
        print(f"train-step-grad: {cfg.name} {n_layers} layers {dtype} batch {batch} x seq "
              f"{seq}: kernel loss {k_loss:.6f} grad_norm {kn:.6g}; against {base}: grad_norm "
              f"rel diff {norm_rel:.3g} (tolerance {tol_norm:.3g}), worst leaf {worst} rel diff "
              f"{leaf_rel[worst]:.3g} (tolerance {tol_leaf:.3g}); largest leaves "
              + ", ".join(f"{k} {k_norms[k]:.4g}" for k in top)
              + f"; embed's share of the squared norm {k_norms['embed'] ** 2 / kn ** 2:.6f}"
              f" ({card})")
        if not (math.isfinite(kn) and norm_rel <= tol_norm and leaf_rel[worst] <= tol_leaf):
            failed.append(f"{n_layers}-layer {dtype}: grad_norm rel diff {norm_rel:.3g} "
                          f"(tolerance {tol_norm:.3g}), {worst} rel diff "
                          f"{leaf_rel[worst]:.3g} (tolerance {tol_leaf:.3g})")
        out[f"{dtype} {n_layers} layers"] = {
            "grad_norm": kn, "against": base, "grad_norm_rel": norm_rel, "worst_leaf": worst,
            "worst_leaf_rel": leaf_rel[worst], "tol": [tol_norm, tol_leaf]}

    for n_layers in (depths[0], cfg.n_layers):
        f32 = dataclasses.replace(cfg, dtype="float32", n_layers=n_layers).validate()
        p = cut(tree_map(lambda x: x.float(), params), n_layers)
        p_loss, truth = _step_grads(f32, p, data, "naive")
        k_loss, k_grads = _step_grads(f32, p, data, "kernel")
        norm_rel, leaf_rel = _grad_diff(k_grads, truth)
        tol_norm, tol_leaf = 0.0, dict.fromkeys(leaf_rel, 0.0)
        pn = _total(_norms(truth))
        print(f"train-step-grad: {n_layers} layers float32: plain loss {p_loss:.6f}, grad_norm "
              f"{pn:.6g}")
        if n_layers != depths[0]:
            draws = []
            for freq in STEP_GRAD_DRAWS:
                with _PerturbedAttention(eps, freq):
                    q_loss, q_grads = _step_grads(f32, p, data, "naive")
                draws.append((q_loss, _total(_norms(q_grads)) / pn, _grad_diff(q_grads, truth)[1]))
                del q_grads
            tol_leaf = {k: 4 * max(d[2][k] for d in draws) for k in leaf_rel}
            tol_loss = 4 * max(abs(d[0] - p_loss) for d in draws)
            lo, hi = min(d[1] for d in draws) / 2, 2 * max(d[1] for d in draws)
            tol_norm = hi - 1.0
            k_ratio = _total(_norms(k_grads)) / pn
            print(f"train-step-grad: {n_layers} layers float32 plain path, attention outputs off "
                  f"by {eps:.3g} ({len(draws)} draws): loss "
                  + ", ".join(f"{d[0]:.6f}" for d in draws) + "; grad_norm / plain "
                  + ", ".join(f"{d[1]:.4g}" for d in draws) + "; kernel: loss "
                  f"{k_loss:.6f} (|diff| tolerance {tol_loss:.3g}), grad_norm / plain "
                  f"{k_ratio:.4g} (within {lo:.4g}-{hi:.4g})")
            if not (abs(k_loss - p_loss) <= tol_loss and lo <= k_ratio <= hi):
                failed.append(f"{n_layers}-layer float32: loss {k_loss:.6f} against "
                              f"{p_loss:.6f} (tolerance {tol_loss:.3g}), grad_norm / plain "
                              f"{k_ratio:.4g} outside {lo:.4g}-{hi:.4g}")
        report(n_layers, "float32", k_loss, _norms(k_grads), norm_rel, leaf_rel,
               "the plain path", tol_norm, tol_leaf)
        del k_grads, p
        bf = dataclasses.replace(cfg, n_layers=n_layers).validate()
        p_loss, p_grads = _step_grads(bf, cut(params, n_layers), data, "naive")
        k_loss, k_grads = _step_grads(bf, cut(params, n_layers), data, "kernel")
        p_norm, p_leaf = _grad_diff(p_grads, truth)
        norm_rel, leaf_rel = _grad_diff(k_grads, truth)
        print(f"train-step-grad: {n_layers} layers bfloat16 plain path against float32: loss "
              f"{p_loss:.6f}, grad_norm rel diff {p_norm:.3g}, worst leaf rel diff "
              f"{max(p_leaf.values()):.3g}")
        report(n_layers, "bfloat16", k_loss, _norms(k_grads), norm_rel, leaf_rel,
               "the float32 plain path", 2 * p_norm, {k: 2 * v for k, v in p_leaf.items()})
        del k_grads, p_grads, truth
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("whole-step gradients: " + "; ".join(failed))
    for n_layers in depths[1:]:
        c = dataclasses.replace(cfg, n_layers=n_layers).validate()
        _, g = _step_grads(c, cut(params, n_layers), data, "kernel")
        print(f"train-step-grad: bf16 kernel path cut to {n_layers} layers: grad_norm "
              f"{_total(_norms(g)):.6g}")
        del g
    for i in range(8):
        _, g = _step_grads(cfg, params, batch_at(i), "kernel")
        norms = _norms(g)
        vals, ids = torch.topk(torch.linalg.vector_norm(g["embed"].float(), dim=-1), 3)
        print(f"train-step-grad: seed-0 weights, batch {i}: grad_norm {_total(norms):.6g}, "
              f"largest leaf {max(norms, key=norms.get)}, largest embed rows "
              + ", ".join(f"token {int(t)} {float(v):.4g}" for t, v in zip(ids, vals)))
        del g
    del params
    torch.cuda.empty_cache()
    print(f"train-step-grad: phase wall {time.perf_counter() - t0:.1f} s")
    return out


def _grad_errs(out, want_out, got, want, names, tol: float) -> dict:
    """Max abs errors of the output and each gradient, each scaled by its
    reference's magnitude (max(1, max|ref|)); raises beyond ``tol``."""
    errs = {"out": out, **dict(zip(names, got))}
    refs = {"out": want_out, **dict(zip(names, want))}
    res = {}
    for k in errs:
        a, r = errs[k].detach().float(), refs[k].detach().float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{k}: non-finite values")
        err = float((a - r).abs().max())
        scale = max(1.0, float(r.abs().max()))
        if err > tol * scale:
            raise AssertionError(f"{k}: max abs err {err:.3g} > {tol:.3g} x {scale:.3g}")
        res[k] = err
    return res


# ---------------------------------------------------------------------- fault
def start_fault() -> Background:
    """``python -m repro_torch.bench.runner --only fault_tolerance`` on the
    card, in the background: its children are fresh interpreters of reduced
    OLMo-1B that mostly wait on their imports, and the train-ssm,
    train-grad, agent and optimizer phases run beside them.  The full twin,
    not the quick one: with the quick twin's 6 samples a side the
    permutation test's p is 0.010-0.017 even when every async sample is
    below every blocking one, so a single slow async save on the card's
    shared disk turns the verdict to ``noise``; 10 a side leave room for
    one."""
    return start_twin("fault_tolerance", quick=False, timeout=600.0)


def phase_fault(twin, card: str) -> dict:
    """The fault-tolerance twin on the card, read where it ends (its
    children are fresh interpreters on the card): kill → resume
    bit-identical, a killed campaign that re-measures nothing, the
    torn-checkpoint fallback and the async-vs-blocking verdict; then
    ``check_fault_tolerance`` here on its JSON."""
    from repro_torch.bench import check

    try:
        waited = twin.finish("fault")
        check.check_fault_tolerance(expect_quick=False, bench_dir=twin.dir)
        res = json.loads((twin.dir / "fault_tolerance.json").read_text())
    finally:
        twin.stop()
    if res["device"] != "cuda" or res["device_name"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"the twin ran on {res['device']} {res['device_name']}")
    tr, v = res["train"], res["ckpt_overhead"]["verdict"]
    print(f"fault: on {res['device_name']}: {tr['kills']} kills at {tr['kill_steps']}, "
          f"bit_identical={tr['bit_identical']}, "
          f"recovery_s {[round(s, 2) for s in tr['recovery_s']]}, "
          f"async blocked ms median {np.median(res['ckpt_overhead']['async_blocked_ms']):.2f} vs "
          f"blocking {np.median(res['ckpt_overhead']['blocking_blocked_ms']):.2f} "
          f"({v['verdict']}, p={v['p_value']}) ({card})")
    print(f"fault: ran {time.perf_counter() - twin.t0:.1f} s beside the train-ssm, train-grad, "
          f"agent and optimizer phases; waited {waited:.1f} s for it at its end")
    return res


# ---------------------------------------------------------------------- agent
def agent_main_path(device, cfg, *, batch: int, seq: int, budget: int = 4,
                    per_config: int = 2, tail: int = 2) -> dict:
    """Figure 1 on ``device``: a spawned agent daemon runs a
    ``torch_train_loop`` session over ``lr_scale`` (bo, ``budget`` configs,
    ``per_config`` steps each) against a live ``run_training``, whose
    telemetry reaches it over the shared-memory channel; every config
    update lands through ``AgentClient`` and ``lr_scale_source``, then the
    best is parked for ``tail`` steps.  Raises unless every update landed
    on the steps it was meant for, a session report arrived and the daemon
    exited."""
    from repro_torch.core.agent import AgentClient, AgentProcess, TrackedInstance, make_session
    from repro_torch.core.channel import MlosChannel
    from repro_torch.runtime.train_loop import run_training, workload_signature

    kernels = _kernels()
    session = make_session("torch_train_loop", "loss", optimizer="bo", budget=budget,
                           samples_per_config=per_config, seed=0,
                           workload=workload_signature(batch, seq, cfg.d_model))
    applied, seen = [], []

    class Dial:
        lr_scale = None

        def apply_settings(self, settings):
            self.lr_scale = float(settings["lr_scale"])
            applied.append(self.lr_scale)

    dial = Dial()
    chan = MlosChannel.create(capacity=1 << 16)
    agent = AgentProcess(chan, session)
    try:
        agent.start()
        client = AgentClient(chan)
        client.register("torch_train_loop", TrackedInstance(dial))
        if client.poll(wait_s=0.002, deadline_s=120.0) != 1:
            raise AssertionError("the agent's first proposal did not arrive")

        def on_step(step, metrics):
            seen.append((dial.lr_scale, metrics["loss"]))
            if (step + 1) % per_config == 0 and len(applied) <= budget:
                if client.poll(wait_s=0.002, deadline_s=120.0) < 1:
                    raise AssertionError(f"no config update after step {step}")

        for fn in kernels.values():
            fn.launches = 0
        out = run_training(cfg, n_steps=budget * per_config + tail, global_batch=batch,
                           seq_len=seq, channel=chan, on_step=on_step,
                           lr_scale_source=lambda: dial.lr_scale, seed=0, device=device)
        launches = {name: fn.launches for name, fn in kernels.items()}
        agent.proc.join(60)
        client.poll()
        exited = not agent.proc.is_alive() and agent.proc.exitcode == 0
    finally:
        if agent.proc.is_alive():
            agent.stop()
        chan.close()
    report = client.report_for("torch_train_loop")
    want = [a for a in applied[:budget] for _ in range(per_config)] + applied[-1:] * tail
    if len(applied) != budget + 1 or [s for s, _ in seen] != want:
        raise AssertionError(f"config updates {applied} landed on steps as {seen}")
    if report is None or report["evaluations"] != budget or \
            report["best_config"]["lr_scale"] != applied[-1]:
        raise AssertionError(f"session report {report} (applied {applied})")
    if not exited:
        raise AssertionError(f"the agent daemon did not exit (exitcode {agent.proc.exitcode})")
    return {"applied": applied, "seen": seen, "report": report, "launches": launches,
            "history": out["history"]}


def phase_agent(device, card: str, batch: int = 4, seq: int = 512) -> dict:
    from repro_torch.configs import get_config

    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    out = agent_main_path(device, cfg, batch=batch, seq=seq)
    print(f"agent: olmo-1b full width, batch {batch} x seq {seq}, bo budget 4 x 2 steps over "
          f"torch_train_loop.lr_scale, a spawned daemon over the shared-memory channel, on {card}")
    for (lr_scale, loss), h in zip(out["seen"], out["history"]):
        print(f"agent: lr_scale {lr_scale:.4g}: loss {loss:.4f}, step_time_s "
              f"{h['step_time_s']:.3f}")
    rep = out["report"]
    print(f"agent: {len(out['applied'])} config updates landed; session report: best "
          f"{rep['best_config']} (loss {rep['best_value']:.4f}) after {rep['evaluations']} "
          f"evaluations; the daemon exited; launches {out['launches']}")
    print(f"agent: phase wall {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------------ optimizer
OPT_PARITY_SEEDS = (0, 1, 2)
OPT_PARITY_ASKS = 3
THETA_RTOL = 1e-8            # fitted θ on the card against the CPU (measured ~1e-14)
SCORE_ATOL = 1e-8            # acquisition scores on the card against the CPU (the
                             # reference's numpy-parity tolerance)


def optimizer_variants_path(device) -> dict:
    """Two kernels and three acquisitions of one shape class (d 6, bucket
    64, pool 1280) in one process: an rbf and a matern32 engine, each asked
    with EI, UCB at β 2 and at β 3 in turn, score the pool as a fresh
    engine on the CPU asked only that way does (argmax equal, scores within
    SCORE_ATOL).  Returns the number of asks compared and the largest
    score difference."""
    from repro_torch.core.optimizers.engine import TorchGP

    rng = np.random.default_rng(11)
    X, y, cand = rng.random((40, 6)), rng.standard_normal(40), rng.random((1280, 6))

    def engine(kernel, dev):
        eng = TorchGP(6, kernel=kernel, device=dev)
        for xi, yi in zip(X, y):
            eng.observe(xi, yi)
        return eng

    asks, worst = 0, 0.0
    for kernel in ("rbf", "matern32"):
        eng = engine(kernel, device)
        for acq, beta in (("ei", 2.0), ("ucb", 2.0), ("ucb", 3.0)):
            idx, scores = eng.suggest(cand, acq, beta)
            ref_idx, ref = engine(kernel, "cpu").suggest(cand, acq, beta)
            err = float(np.max(np.abs(scores - ref)))
            if idx != ref_idx or not err <= SCORE_ATOL:
                raise AssertionError(f"{kernel} {acq} beta {beta} on {device}: argmax {idx} vs "
                                     f"cpu {ref_idx}, max score diff {err}")
            asks, worst = asks + 1, max(worst, err)
    return {"asks": asks, "max_abs_err": worst}


def optimizer_main_path(device, *, quick: bool = False) -> dict:
    """The GP engine on ``device``: the throughput twin (the reference's full
    size unless ``quick``), then suggestion parity at fixed hypers (the
    torch engine on ``device``, the same engine on the CPU and the numpy
    backend propose the same configs, 3 seeds x 3 asks) and the fitted θ on
    ``device`` against the CPU's.  Raises unless suggest and append ran as
    programs built per shape class (on the card: captured once, then
    replayed) and the batched ask returned the sequential asks' configs."""
    from repro_torch.bench import optimizer_throughput as ot
    from repro_torch.core.compilecache import step_counts
    from repro_torch.core.optimizers.engine import batched_ask

    before = step_counts()
    res = ot.run(quick=quick, device=device)
    steps = {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
             for k, v in step_counts().items() if k.startswith("gp.")}
    on_card = torch.device(device).type == "cuda"
    for key in ("gp.suggest", "gp.append", "gp.suggest_batched"):
        c = steps[key]
        if on_card and (c["captures"] + c["replays"] != c["runs"] or c["replays"] <= c["captures"]):
            raise AssertionError(f"{key}: {c}: not replays of programs captured per shape class")

    rows = []
    for seed in OPT_PARITY_SEEDS:
        opts = [ot.with_history(backend, seed, 25, dev, fit_hypers=False)
                for backend, dev in (("torch", device), ("torch", "cpu"), ("numpy", "cpu"))]
        for _ in range(OPT_PARITY_ASKS):
            cfgs = [o.ask() for o in opts]
            if cfgs[0] != cfgs[1] or cfgs[0] != cfgs[2]:
                raise AssertionError(f"seed {seed}: {device} / cpu / numpy suggested {cfgs}")
            rows.append(cfgs[0])
            for o, c in zip(opts, cfgs):
                o.tell(c, ot.objective(c))
    fitted = [ot.with_history("torch", 1, 40, dev) for dev in (device, "cpu")]
    for o in fitted:
        o.ask()
    th_dev, th_cpu = (o._engine.theta for o in fitted)
    theta_rel = float(np.max(np.abs(th_dev / th_cpu - 1.0)))
    if not theta_rel <= THETA_RTOL:
        raise AssertionError(f"fitted theta on {device} {th_dev} vs cpu {th_cpu}: rel {theta_rel}")
    variants = optimizer_variants_path(device)
    seq = [ot.with_history("torch", 7 + s, 25, device) for s in range(8)]
    bat = [ot.with_history("torch", 7 + s, 25, device) for s in range(8)]
    for _ in range(2):
        a, b = [o.ask() for o in seq], batched_ask(bat)
        if a != b:
            raise AssertionError(f"the batched ask of 8 sessions {b} != sequential {a}")
        for o, c in zip(seq + bat, a + b):
            o.tell(c, ot.objective(c))
    return {"throughput": res, "steps": steps, "parity_asks": len(rows),
            "variants": variants,
            "theta": {"device": th_dev.tolist(), "cpu": th_cpu.tolist(), "rel": theta_rel}}


def optimizer_sweep_path(device, *, quick: bool = False, out_dir) -> dict:
    """The campaign-sweep twin with the numpy default and with every BO on
    the torch engine on ``device``: warm beats cold both times, and every
    target cell is promoted under this process's hardware fingerprint."""
    from repro_torch.bench import campaign_sweep, check
    from repro_torch.core.configstore import hardware_fingerprint

    out = {}
    for backend in ("numpy", "torch"):
        res = campaign_sweep.run(quick=quick, backend=backend, device=device,
                                 out_dir=Path(out_dir) / backend)
        check.check_campaign_sweep(expect_quick=quick, bench_dir=Path(out_dir) / backend)
        hw = {row["promoted_under"] for row in res["cells"].values()}
        if hw != {hardware_fingerprint()}:
            raise AssertionError(f"{backend}: cells promoted under {hw}")
        out[backend] = res
    return out


def optimizer_grid_path(device, *, budget: int = 12, quick: bool = False) -> dict:
    """The ``kernels`` grid with ``optimizer.backend=torch`` (on ``device``)
    into a temporary store and journal: every cell done and promoted; the
    kernels' launches during the grid."""
    import tempfile

    from repro_torch.core import configstore
    from repro_torch.core.optimizers import optimizer_defaults, set_optimizer_defaults
    from repro_torch.launch import campaign as launch
    from repro_torch.launch.tuning import apply_overrides, parse_override

    kernels = _kernels()
    old = optimizer_defaults()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_optimizer_grid_") as tmp:
        store = configstore.ConfigStore(Path(tmp) / "store")
        old_store = configstore.set_default_store(store)
        try:
            for s in ("optimizer.backend=torch", f"optimizer.device={torch.device(device).type}"):
                apply_overrides(parse_override(s))
            for fn in kernels.values():              # counts of this path only
                fn.launches = 0
            t0 = time.perf_counter()
            camp, results = launch.run_grid("kernels", budget=budget, optimizer="bo", seed=0,
                                            quick=quick, device=device,
                                            campaign_id="chip-smoke-optimizer", store=store,
                                            journal_root=Path(tmp) / "journal")
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in kernels.items()}
            done = set(camp.journal.completed())
        finally:
            set_optimizer_defaults(**old)
            configstore.set_default_store(old_store)
    cell_ids = {c.cell_id for c in camp.cells}
    if done != cell_ids:
        raise AssertionError(f"cells without a cell_done row: {sorted(cell_ids - done)}")
    if not all(r.promoted for r in results.values()):
        raise AssertionError("cells not promoted: "
                             + "; ".join(launch.describe(r) for r in results.values()
                                         if not r.promoted))
    return {"results": results, "launches": launches, "wall_s": wall,
            "measure_calls": camp.measure_calls}


def optimizer_daemon_path(device, *, out_dir, budget: int = 16) -> dict:
    """A spawned agent daemon with the optimizer defaults ``{"backend":
    "torch", "device": device}`` drives the multi-instance twin's 4
    ``bo_torch`` sessions on ``torch_hashtable``; its bests, value and
    config, must equal an in-process drive of the same sessions."""
    from repro_torch.bench import multi_instance
    from repro_torch.core.optimizers import optimizer_defaults, set_optimizer_defaults

    old = optimizer_defaults()
    set_optimizer_defaults(backend="torch")
    try:
        res = multi_instance.run(budget=budget, optimizer="bo_torch", device=device,
                                 out_dir=out_dir)
    finally:
        set_optimizer_defaults(**old)
    bad = {k: v for k, v in res["instances"].items()
           if not v["identical"] or v["evaluations"] != budget}
    if bad:
        raise AssertionError(f"daemon bests differ from the in-process drive: {bad}")
    return res


def phase_optimizer(device, card: str) -> dict:
    """Phase 19: the GP engine on the card (see the module docstring)."""
    import tempfile

    from repro_torch.launch.campaign import describe

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_optimizer_") as tmp:
        main_out = optimizer_main_path(device)
        sweep = optimizer_sweep_path(device, out_dir=tmp)
        grid = optimizer_grid_path(device)
        daemon = optimizer_daemon_path(device, out_dir=tmp)
    thr = main_out["throughput"]
    for n, row in thr["ask_latency_ms"].items():
        e = thr["engine"][n]
        print(f"optimizer: n={n} (bucket {e['ask_bucket']}): ask numpy {row['numpy']:.2f} ms, "
              f"torch {row['torch']:.4f} ms ({row['speedup']:.1f}x); first asks "
              f"{[round(t, 2) for t in e['first_asks_ms']]} ms; then tell {e['tell_ms']:.4f} ms "
              f"and refit {e['refit_ms']:.3f} ms (to n={e['n_after']}, bucket {e['bucket']}) "
              f"({card})")
    for h, row in thr["batched"].items():
        print(f"optimizer: 8 sessions at n={h}: sequential {row['sequential_ms']:.3f} ms, batched "
              f"{row['batched_ms']:.3f} ms ({row['speedup']:.2f}x)")
    print("optimizer: programs (runs / captures / replays): " + ", ".join(
        f"{k} {v['runs']}/{v['captures']}/{v['replays']}" for k, v in sorted(main_out["steps"].items())))
    print(f"optimizer: {main_out['parity_asks']} asks at fixed hypers identical on {device}, cpu "
          f"and numpy; fitted theta rel diff {main_out['theta']['rel']:.3g} "
          f"(tol {THETA_RTOL}); batched ask of 8 = sequential; {main_out['variants']['asks']} asks "
          f"over rbf/matern32 x ei/ucb(2)/ucb(3) at one shape class equal fresh cpu engines, "
          f"max score diff {main_out['variants']['max_abs_err']:.3g} (tol {SCORE_ATOL})")
    for backend, res in sweep.items():
        print(f"optimizer: campaign sweep ({backend}): cold {res['cold_iters_total']} -> warm "
              f"{res['warm_iters_total']} evals, every cell promoted under {res['hardware']}, "
              f"wall {res['wall_s']:.2f} s")
    print(f"optimizer: kernels grid with optimizer.backend=torch, bo budget 12: "
          f"{len(grid['results'])} cells done and promoted, {grid['measure_calls']} measurements, "
          f"wall {grid['wall_s']:.1f} s, launches {grid['launches']}")
    for _, r in sorted(grid["results"].items()):
        print("optimizer: " + describe(r))
    print(f"optimizer: spawned daemon (backend torch on {device}), 4 bo_torch sessions, budget 16: "
          f"bests {[v['multiplexed_best'] for v in daemon['instances'].values()]} and their "
          f"configs equal the in-process drive's; wall {daemon['multiplexed_wall_s']:.1f} s")
    print(f"optimizer: phase wall {time.perf_counter() - t0:.1f} s")
    return {"launches": grid["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a GPU", file=sys.stderr)
        return 2
    # cuBLAS reads its workspace setting when its first handle is made: set
    # before any product, so the train phases' steps are deterministic
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
    device = torch.device("cuda")
    _import_port()
    card = phase_card()
    builds = phase_build()
    errs = phase_kernels(device)
    ssd_errs = phase_kernels_ssd(device)
    rms_errs = phase_kernels_rmsnorm(device)
    serves = {
        "olmo-1b": phase_serve(device, card),
        "mamba2-780m": phase_serve(device, card, "mamba2-780m", label="serve-ssm"),
        "hymba-1.5b": phase_serve(device, card, "hymba-1.5b", n_requests=8,
                                  widths=[2, 8, 32, 64, 128, 256, 512, 1024],
                                  label="serve-hybrid"),
    }
    _memory("serve phases", t_start)
    for name in serves:
        phase_model(device, name)
    _memory("model", t_start)
    graphs = phase_graphs(device, card, serves)
    _memory("graphs", t_start)
    timing = phase_timing(device)
    timing_ssd = phase_timing_ssd(device)
    timing_rms = phase_timing_rmsnorm(device)
    _memory("timing", t_start)
    campaign = phase_campaign(device, card)
    _memory("campaign", t_start)
    paths = {"graphs": graphs, "online": phase_online(device, card, serves["olmo-1b"])}
    _memory("online", t_start)
    paths["serve-bench"] = phase_serve_bench(device, card, serves["olmo-1b"])
    _memory("serve-bench", t_start)
    paths["serving-grid"] = phase_serving_grid(device, card)
    _memory("serving-grid", t_start)
    phase_figures(device, card)
    _memory("figures", t_start)
    for name, out in phase_examples(device, card).items():
        paths[name] = out
    _memory("examples", t_start)
    # the graph profiles only (PERF.md section 5 reads them); the eager ones
    # are cut to keep the script inside its time
    phase_profile(device, serves["olmo-1b"], card, "graph")
    phase_profile(device, serves["mamba2-780m"], card, "graph")
    _memory("profile", t_start)

    # the serving paths' servers, weights and graph pools go before training
    path_launches = {name: out["launches"] for name, out in serves.items()}
    path_launches["campaign"] = campaign["launches"]
    path_launches.update({name: out["launches"] for name, out in paths.items()})
    del serves, paths, graphs, campaign
    _release()
    _memory("serving released", t_start)
    cold_warm = start_cold_warm()
    # one MoE model's weights at a time: drawing a stacked leaf takes twice
    # its float32 size for a moment (Mixtral's wi_gate at 4 layers: 26 GB)
    moe_runs = {"serve-moe": dict(name="olmoe-1b-7b"),
                "serve-moe-window": dict(name="mixtral-8x22b", n_requests=8,
                                         widths=MOE_WINDOW_WIDTHS, capacity=MOE_WINDOW_CAPACITY,
                                         max_width=max(MOE_WINDOW_WIDTHS),
                                         n_layers=MOE_WINDOW_LAYERS)}
    path_launches["graphs-moe"] = dict.fromkeys(_kernels(), 0)
    for label, kw in moe_runs.items():
        serve = phase_serve(device, card, label=label, **kw)
        path_launches[label] = serve["launches"]
        graphs = phase_graphs(device, card, {kw["name"]: serve}, label="graphs-moe")
        for k, n in graphs["launches"].items():
            path_launches["graphs-moe"][k] += n
        del serve, graphs
        _release()
        _memory(f"{label}, graphs-moe", t_start)
    for name in ("olmoe-1b-7b", "mixtral-8x22b"):
        phase_model(device, name)
    phase_moe_dispatch(device, card)
    _memory("model-moe, moe-dispatch", t_start)
    _release()
    # the encoder-decoder and the VLM, one model's weights at a time (the
    # VLM's stacked float32 wi is 9.4 GB for a moment)
    path_launches["graphs-xattn"] = dict.fromkeys(_kernels(), 0)
    for label, name in XATTN_NAMES.items():
        serve = phase_serve(device, card, name, label=label, capacity=XATTN_CAPACITY,
                            divergences=False)
        path_launches[label] = serve["launches"]
        graphs = phase_graphs(device, card, {name: serve}, label="graphs-xattn")
        for k, n in graphs["launches"].items():
            path_launches["graphs-xattn"][k] += n
        del serve, graphs
        _release()
        _memory(f"{label}, graphs-xattn", t_start)
    path_launches["model-xattn"] = phase_model_xattn(device, card)["launches"]
    _memory("model-xattn", t_start)
    path_launches["train-moe"] = phase_train_moe(device, card)["launches"]
    _release()
    _memory("train-moe", t_start)
    path_launches["train-encdec"] = phase_train_encdec(device, card)["launches"]
    _release()
    _memory("train-encdec", t_start)
    path_launches["cold-warm"] = phase_cold_warm(cold_warm, card)["path_launches"]
    _memory("cold-warm", t_start)
    path_launches["train"] = phase_train(device, card, continued=True)["launches"]
    phase_train_profile(device, card)
    _memory("train", t_start)
    path_launches["training-grid"] = phase_training_grid(device, card)["launches"]
    _memory("training-grid", t_start)
    fault = start_fault()
    path_launches["train-ssm"] = phase_train(device, card, "mamba2-780m", batch=4, seq=1024,
                                             steps=1, resume_to=2, ckpt_every=1,
                                             label="train-ssm")["launches"]
    _memory("train-ssm", t_start)
    grad_errs = phase_train_grad(device)
    step_grad = phase_train_step_grad(device, card,
                                      eps=grad_errs[("attention", torch.float32)]["out"])
    _memory("train-grad", t_start)
    path_launches["agent"] = phase_agent(device, card)["launches"]
    _memory("agent", t_start)
    path_launches["optimizer-grid"] = phase_optimizer(device, card)["launches"]
    _memory("optimizer", t_start)
    phase_fault(fault, card)
    _memory("fault", t_start)

    def launches(kernel_name):
        by_path = {name: n[kernel_name] for name, n in path_launches.items()
                   if n[kernel_name] or name == "campaign"}
        return sum(by_path.values()), by_path

    def grad_err(kernel_name):
        return {str(dtype).split(".")[-1]: max(e.values())
                for (k, dtype), e in grad_errs.items() if k == kernel_name}

    timed = ("ms", "ms_device", "plain_ms", "plain_ms_device", "library_ms",
             "library_ms_device", "bound_ms", "bound_by")

    def entry(name, source, replaces, errs_by_dtype, timing, shape, **extra):
        n, by_path = launches(name)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "launches_by_path": by_path,
                "max_abs_err": max(errs_by_dtype.values()), "max_abs_err_by_dtype": errs_by_dtype,
                **{key: timing[key] for key in timed}, "kernel_ms": timing["ms"],
                "shape": shape, "card": card, **extra}

    line = {"kernels": [
        entry("flash_attention", "src/repro_torch/csrc/flash_attention_tc.cu",
              "src/repro/kernels/flash_attention/kernel.py:85", errs, timing,
              timing["shape"], source_float32="src/repro_torch/csrc/flash_attention.cu",
              shapes=timing["shapes"], build={k: builds[k] for k in ("flash_attention_tc",
                                                                      "flash_attention")},
              train_grad_max_abs_err=grad_err("attention"), train_step_grad=step_grad),
        entry("ssd", "src/repro_torch/csrc/ssd_tc.cu", "src/repro/kernels/ssd/kernel.py:74",
              ssd_errs["y"], timing_ssd, timing_ssd["shape"] + " chunk 64",
              source_float32="src/repro_torch/csrc/ssd.cu", shapes=timing_ssd["shapes"],
              max_abs_err_state=ssd_errs["state"],
              build={k: builds[k] for k in ("ssd_tc", "ssd")},
              train_grad_max_abs_err=grad_err("ssd")),
        entry("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm/kernel.py:33", rms_errs, timing_rms["rmsnorm"],
              "bf16 r16384 d1536, bf16 scale", residual=timing_rms["rmsnorm_res"],
              build=builds["rmsnorm"]),
    ]}
    print(f"chip_smoke: total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_background()
    sys.exit(rc)
