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
                     reduced OLMo-1B's GQA 4->2 at head dim 16; GQA,
                     window, q_offset, non-pow2; the campaign grid's four shapes
                     at every tile pair compiled for the dtype; the
                     libraries' shared-memory tables against the
                     wrapper's), the SSD scan at both
                     compiled chunks, bf16 through ``ssd_tc`` and float32
                     through ``ssd`` (y and the final state; mamba2's and
                     hymba's prefill widths 2…1024, the grid's b2s512h48,
                     G = 2, non-pow2 S) and RMSNorm (tests/test_kernels.py's
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
                     server of each path (eager, graph): tokens/s and p50,
                     then under torch.profiler (device activity only) the
                     device's busy share and top kernels.
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
                     warm-up and 5 timed replays per scheduler, records into
                     a temporary trajectory; medians of tokens/s, p50 and
                     p99, the continuous-vs-gang verdict (printed, not
                     gated; equal token totals gated) and the idle share of
                     one more continuous replay under the profiler.
 13. serving-grid  — the ``serving`` campaign grid on the card (reduced
                     OLMo-1B, bf16, bo budget 3) into a temporary store:
                     every cell done, every entry filed under this card, a
                     rerun under the same id measures nothing.

Phases 11-13 run after the campaign phase, before the profiles.  Each phase
from 11 on prints its wall time; after each phase the script prints the
memory the caching allocator reserved (``torch.cuda.max_memory_reserved``)
and the time since the start, and it prints its total before the last two
lines of standard output: the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  The port imports no jax and nothing of
the reference package, and neither does this script.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
# (batch, seq_q, seq_k, heads, kv_heads, head_dim, window, q_offset)
ATTN_CASES = [
    # OLMo-1B prefill shapes: every pow2 prompt width the server can give
    *((1, w, w, 16, 16, 128, 0, 0) for w in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)),
    # hymba-1.5b prefill shapes: GQA 25->5, head_dim 64, window 2048 (wider than any prompt)
    *((1, w, w, 25, 5, 64, 2048, 0) for w in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)),
    # OLMo-1B gang prefills (serve-bench): max_batch 4 rows at every pow2 heavy-tail width
    *((4, w, w, 16, 16, 128, 0, 0) for w in (2, 4, 8, 16, 32, 64)),
    # reduced OLMo-1B prefills (serving grid, f32 parity phases): GQA 4->2, head_dim 16
    *((1, w, w, 4, 2, 16, 0, 0) for w in (2, 4, 8, 16, 32)),
    (2, 256, 256, 32, 8, 128, 0, 0),      # GQA
    (1, 300, 300, 16, 16, 128, 48, 0),    # sliding window
    (1, 100, 228, 8, 8, 64, 0, 128),      # q_offset > 0 (chunked prefill)
    (2, 77, 77, 4, 2, 32, 0, 0),          # non-pow2, ragged tiles
    (1, 40, 40, 4, 4, 16, 0, 0),
]
# The `kernels` campaign grid's attention shapes (OLMo-1B heads, causal):
# every (block_q, block_kv) pair compiled for the dtype, which the grid
# times and may promote
ATTN_GRID_CASES = [(b, s, s, 16, 16, 128, 0, 0) for b, s in ((1, 128), (2, 256), (2, 512),
                                                           (4, 1024))]
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


def _expected_launches(cfg, prefills: int) -> dict:
    """One launch per layer per prefill of each kernel the family runs (the
    models normalize inline: RMSNorm's kernel is on the tuning path only)."""
    uses = {"flash_attention": cfg.family in ("dense", "hybrid"),
            "ssd": cfg.family in ("ssm", "hybrid"), "rmsnorm": False}
    return {k: prefills * cfg.n_layers if used else 0 for k, used in uses.items()}


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
    b, sq, sk, h, kh, d, _, _ = case
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device).to(dtype)
    return mk(b, sq, h, d), mk(b, sk, kh, d), mk(b, sk, kh, d)


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
            (case, bq, bk) for case in ATTN_GRID_CASES for bq, bk in pairs]
        worst = 0.0
        for i, (case, bq, bk) in enumerate(cases):
            q, k, v = _qkv(case, dtype, device, seed=1000 + i)
            window, q_offset = case[6], case[7]
            got = kernel.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset,
                                         block_q=bq, block_kv=bk)
            want = ref.naive_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
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
              f"tile pairs {pairs}, max abs err {worst:.3g} (tol {TOL[dtype]:.3g} abs + rel)")
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
    launch per layer of every kernel its family runs (a capture records the
    wrappers' launches, a replay adds them back)."""
    return srv.prefill_calls, srv.graphs.captures.get("serve.prefill", 0)


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
                             f"captures) x {cfg.n_layers} layers of {cfg.family}; "
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
                widths: Optional[list] = None, label: str = "serve") -> dict:
    from repro_torch.configs import get_config

    cfg = get_config(name)
    out = serve_main_path(device, cfg, capacity=2048, max_batch=8, n_requests=n_requests,
                          max_width=1024, widths=widths)
    out["widths_asked"] = widths
    m = out["metrics"]
    launched = ", ".join(f"{n} {k} launches" for k, n in out["launches"].items() if n)
    print(f"{label}: {name} full width ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f} B params, bf16) on {card}")
    print(f"{label}: {int(m['completed'])} requests, widths {sorted(set(out['widths']))}, "
          f"{int(m['total_tokens'])} tokens, {int(m['decode_steps'])} decode steps, "
          f"{out['host_fetches']} host fetches, step={out['step']}: {out['prefill_calls']} "
          f"prefills + {out['captures']} prefill captures, {launched} (= (prefills + "
          f"captures) x {cfg.n_layers} layers); registry {_registry_line(out['registry'])}")
    print(f"{label}: smoke reading, one cold run: continuous tokens_per_s "
          f"{m['tokens_per_s']:.2f}, p50_latency_s {m['p50_latency_s']:.4f}, "
          f"p99_latency_s {m['p99_latency_s']:.4f} ({card})")
    print(f"{label}: gang vs continuous identical token streams: "
          f"{out['identical_share']:.3f} of requests")
    for d in out["divergences"]:
        print(f"{label}: divergence rid {d['rid']} at step {d['step']}: "
              f"top-2 logit gap at batch 1 {d['top2_gap']:.4g}")
    if out["divergences"]:
        print(f"{label}: (reported, not a gate: in bf16 a decode step at batch 8 and one at "
              "batch 1 round differently; the f32 serve in the model phase must agree)")
    out["cfg"] = cfg
    del out["server"]               # its graphs and caches go with it
    return out


def _registry_line(c: dict) -> str:
    return (f"captures {int(c['captures'])}, replays {int(c['replays'])}, build "
            f"{c['build_seconds']:.2f} s, hits {int(c['hits'])}, misses {int(c['misses'])}")


def _memory(label: str, t_start: float) -> None:
    print(f"{label}: torch.cuda.max_memory_reserved {torch.cuda.max_memory_reserved() / 2**30:.2f} "
          f"GiB, memory_reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB; "
          f"{time.perf_counter() - t_start:.1f} s since the start")


# ------------------------------------------------------------------- graphs
GRAPH_DECODE_STEPS = 20


def decode_step_timing(srv, steps: int = GRAPH_DECODE_STEPS) -> dict:
    """``steps`` decode steps of a warm server (after its run: every slot
    done, so the state it advances is never read): CUDA events around them
    (device ms a step, host gaps included where the host is slower), the
    host's wall a step (enqueue to the end of the last step), and the
    device's busy time a step and idle share under torch.profiler (device
    activity only)."""
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
        busy, window, n_ops, _ = found
        out.update(busy_ms=busy / 1e3 / steps, idle_share=1 - busy / window,
                   ops_per_step=n_ops / steps)
    return out


def phase_graphs(device, card: str, serves: dict) -> dict:
    """Each full-width model (the serve phases' weights and smoke mix, bf16,
    capacity 2048, max_batch 8) served with ``step="eager"`` and with
    ``step="graph"``: the same step bodies on the same static buffers,
    without and with capture.  Fails unless every request's token stream is
    identical between the two and the launch counts are exact on both.
    Prints, per path, tokens/s and p50/p99 of the run (a graph server
    captures during it), the decode step's device and host time, and the
    registry's counters."""
    out = {}
    for name, serve in serves.items():
        cfg = serve["cfg"]
        runs = {}
        for step in ("eager", "graph"):
            r = serve_main_path(device, cfg, capacity=2048, max_batch=8,
                                n_requests=len(serve["arrivals"]), max_width=1024,
                                widths=serve["widths_asked"], step=step,
                                params=serve["params"], divergences=False)
            r["decode"] = decode_step_timing(r.pop("server"))
            runs[step] = r
            m, d = r["metrics"], r["decode"]
            print(f"graphs: {name} step={step}: tokens_per_s {m['tokens_per_s']:.2f}, "
                  f"p50_latency_s {m['p50_latency_s']:.4f}, p99_latency_s "
                  f"{m['p99_latency_s']:.4f}; decode step at batch 8: {d['events_ms']:.3f} ms "
                  f"by events, host wall {d['host_ms']:.3f} ms, device busy "
                  f"{d.get('busy_ms', float('nan')):.3f} ms (idle share "
                  f"{d.get('idle_share', float('nan')):.3f}, "
                  f"{d.get('ops_per_step', float('nan')):.0f} device ops a step); "
                  f"{r['prefill_calls']} prefills + {r['captures']} captures, launches "
                  f"{r['launches']}; registry {_registry_line(r['registry'])} ({card})")
        eager, graph = runs["eager"]["streams"], runs["graph"]["streams"]
        differ = [rid for rid in eager if eager[rid] != graph[rid]]
        for rid in differ:
            t = next(i for i, (x, y) in enumerate(zip(eager[rid], graph[rid])) if x != y)
            print(f"graphs: {name}: request {rid} differs at step {t}: eager "
                  f"{eager[rid][t:t + 4]}, graph {graph[rid][t:t + 4]}")
        if differ:
            raise AssertionError(f"{name}: {len(differ)} of {len(eager)} token streams differ "
                                 "between the eager and the graph path")
        print(f"graphs: {name}: eager and graph streams identical for {len(eager)} of "
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


def phase_model(device, name: str) -> float:
    """A reduced config in float32: card (kernel path) vs CPU (plain path),
    prefill at widths 24 (non-pow2: ragged kernel tiles and chunks) and 2
    (shorter than the SSM's conv history) + 3 decode steps; then served on
    the card."""
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
    replays = 1 + repeats                            # the warm-up, then the timed ones
    prefills = replays * (n + math.ceil(n / twin.MAX_BATCH))   # continuous: one a request
    steps = compilecache.step_counts().get("serve.prefill", {})
    ran = steps.get("runs", 0) - steps0.get("runs", 0)
    if ran != prefills:
        raise AssertionError(f"the registry ran serve.prefill {ran} times; {replays} replays of "
                             f"{n} requests make {prefills} prefills")
    captures = steps.get("captures", 0) - steps0.get("captures", 0)
    return {"res": res, "rows": rows, "launches": launches, "prefills": prefills,
            "captures": captures}


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
          f"prefill captures) x {cfg.n_layers} layers; every server captures its own graphs, "
          f"so each timed replay includes its servers' captures)")

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
def serving_grid_path(device, *, budget: int, campaign_id: str = "chip-smoke-serving") -> dict:
    """The ``serving`` campaign grid into a temporary store and journal (the
    default store for the phase), then again under the same id.  Raises
    unless every cell is done, every entry is filed under this process's
    hardware and software, every promoted cell resolves its best, and the
    rerun measures nothing."""
    import tempfile

    from repro_torch.core import configstore
    from repro_torch.launch import campaign as launch
    from repro_torch.runtime import serve_loop

    kernels = _kernels()
    hw, sw = configstore.hardware_fingerprint(), configstore.sw_fingerprint()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as tmp:
        store = configstore.ConfigStore(Path(tmp) / "store")
        old = configstore.set_default_store(store)
        try:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            for fn in kernels.values():              # counts of this path only
                fn.launches = 0
            t0 = time.perf_counter()
            camp, results = launch.run_grid("serving", budget=budget, optimizer="bo", seed=0,
                                            device=device, campaign_id=campaign_id, store=store,
                                            journal_root=Path(tmp) / "journal")
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in kernels.items()}
            cell_ids = {c.cell_id for c in camp.cells}
            if len(cell_ids) != 2 or set(camp.journal.completed()) != cell_ids:
                raise AssertionError(f"cells without a cell_done row: "
                                     f"{sorted(cell_ids - set(camp.journal.completed()))}")
            path = store.root / "torch_serve_batching.json"
            entries = json.loads(path.read_text())["entries"] if path.exists() else []
            for e in entries:
                if e["context"]["hardware"] != hw or e["context"]["sw"] != sw:
                    raise AssertionError(f"entry filed under {e['context']}, not {hw} / {sw}")
            for r in results.values():
                got = serve_loop.serve_settings.settings_for(r.cell.workload)
                if r.promoted and got != r.best_config:
                    raise AssertionError(f"{r.cell.cell_id}: settings_for gives {got}, "
                                         f"promoted {r.best_config}")
            again, res2 = launch.run_grid("serving", budget=budget, optimizer="bo", seed=0,
                                          device=device, campaign_id=campaign_id, store=store,
                                          journal_root=Path(tmp) / "journal")
            if again.measure_calls != 0 or not all(r.resumed for r in res2.values()):
                raise AssertionError(f"resume re-measured: {again.measure_calls} calls")
        finally:
            configstore.set_default_store(old)
    return {"results": results, "measure_calls": camp.measure_calls, "entries": len(entries),
            "hardware": hw, "wall_s": wall, "launches": launches}


def phase_serving_grid(device, card: str) -> dict:
    """The ``serving`` grid on the card (reduced OLMo-1B, bf16, budget 3);
    the grid must launch the attention kernel."""
    from repro_torch.launch import campaign as launch

    t0 = time.perf_counter()
    out = serving_grid_path(device, budget=3)
    print(f"serving-grid: reduced olmo-1b, bf16, {len(out['results'])} cells, bo budget 3, "
          f"{out['measure_calls']} measurements, wall {out['wall_s']:.1f} s, on {card}")
    for _, r in sorted(out["results"].items()):
        print("serving-grid: " + launch.describe(r))
    if not out["launches"]["flash_attention"]:
        raise AssertionError(f"the serving grid launched no attention kernel: {out['launches']}")
    print(f"serving-grid: {out['entries']} entries filed under {out['hardware']}; launches "
          f"{out['launches']}; a rerun under the same id measured nothing")
    print(f"serving-grid: phase wall {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a GPU", file=sys.stderr)
        return 2
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
    for step in ("eager", "graph"):
        phase_profile(device, serves["olmo-1b"], card, step)
        phase_profile(device, serves["mamba2-780m"], card, step)
    _memory("profile", t_start)

    def launches(kernel_name):
        by_path = {name: out["launches"][kernel_name] for name, out in serves.items()
                   if out["launches"][kernel_name]}
        by_path["campaign"] = campaign["launches"][kernel_name]
        by_path.update({name: out["launches"][kernel_name] for name, out in paths.items()
                        if out["launches"][kernel_name]})
        return sum(by_path.values()), by_path

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
                                                                      "flash_attention")}),
        entry("ssd", "src/repro_torch/csrc/ssd_tc.cu", "src/repro/kernels/ssd/kernel.py:74",
              ssd_errs["y"], timing_ssd, timing_ssd["shape"] + " chunk 64",
              source_float32="src/repro_torch/csrc/ssd.cu", shapes=timing_ssd["shapes"],
              max_abs_err_state=ssd_errs["state"],
              build={k: builds[k] for k in ("ssd_tc", "ssd")}),
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
    sys.exit(main())
