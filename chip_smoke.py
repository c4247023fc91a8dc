#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

  1. card    — the GPU's name and power limit (nvidia-smi); TF32 off for
               float32 matmuls and convolutions.
  2. build   — compile every CUDA kernel of the serving path from
               ``src/repro_torch/csrc`` into ``build/kernels/``.
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the serving path's shapes and at edge shapes (GQA, window,
               q_offset, a non-pow2 sequence), bf16 and float32.
  4. serve   — full-width OLMo-1B (random bf16 weights from a seed) served
               by the continuous ``BatchedServer`` over the seeded
               heavy-tail mix with one prompt per pow2 prefill bucket up
               to 1024; the kernels' launch counts are zeroed just
               before and read just after.  The same requests then run
               one at a time (gang mode at batch 1, the sequential
               reference), and the share of identical token streams is
               reported with the top-2 logit gap at each divergence.
  5. model   — the reduced OLMo-1B in float32 on the card (kernel path) vs
               the same weights on the CPU (plain path), and served on the
               card: continuous streams equal the one-at-a-time ones.
  6. timing  — each kernel, its plain version and the one PyTorch call that
               computes the same function, with CUDA events, beside the
               card's bound for the work.
  7. profile — the main path's requests again, warm: tokens/s and p50, then
               under torch.profiler the device's busy share and top kernels.

The last two lines of standard output are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  The port imports no jax and nothing of
the reference package, and neither does this script.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak, FLOP/s
PEAK_BYTES = 3.35e12         # H100 SXM HBM3, bytes/s
TOL = {torch.bfloat16: 5.0 * 2.0 ** -8,                      # inputs rounded, f32 accumulation
       torch.float32: 170.0 * float(np.finfo(np.float32).eps)}  # rounding inside the reductions
SEED = 17
# (batch, seq_q, seq_k, heads, kv_heads, head_dim, window, q_offset)
ATTN_CASES = [
    # OLMo-1B prefill shapes: every pow2 prompt width the server can give
    *((1, w, w, 16, 16, 128, 0, 0) for w in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)),
    (2, 256, 256, 32, 8, 128, 0, 0),      # GQA
    (1, 300, 300, 16, 16, 128, 48, 0),    # sliding window
    (1, 100, 228, 8, 8, 64, 0, 128),      # q_offset > 0 (chunked prefill)
    (2, 77, 77, 4, 2, 32, 0, 0),          # non-pow2, ragged tiles
    (1, 40, 40, 4, 4, 16, 0, 0),
]


def _import_port():
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import kernel, ref
    return kernel, ref


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
def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build(["flash_attention"])
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_name(path.name + ".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln]
        print(f"build: {name}: {len(usage)} kernels; ptxas: {usage[:2]}")


# ------------------------------------------------------------------ kernels
def _qkv(case, dtype, device, seed):
    b, sq, sk, h, kh, d, _, _ = case
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device).to(dtype)
    return mk(b, sq, h, d), mk(b, sk, kh, d), mk(b, sk, kh, d)


def phase_kernels(device) -> dict:
    """Kernel vs plain on the card; returns the max abs error per dtype."""
    kernel, ref = _import_port()
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for i, case in enumerate(ATTN_CASES):
            q, k, v = _qkv(case, dtype, device, seed=1000 + i)
            window, q_offset = case[6], case[7]
            got = kernel.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
            want = ref.naive_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            tol = TOL[dtype]
            bad = err > tol + tol * want.float().abs()
            if not torch.isfinite(got).all() or bad.any():
                raise AssertionError(f"kernel disagrees with naive_attention at {case} {dtype}: "
                                     f"max abs err {err.max().item():.3g}, tol {tol:.3g}")
            worst = max(worst, err.max().item())
        errs[str(dtype).replace("torch.", "")] = worst
        print(f"kernels: flash_attention vs naive_attention, {dtype}: {len(ATTN_CASES)} cases, "
              f"max abs err {worst:.3g} (tol {TOL[dtype]:.3g} abs + rel)")
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


def smoke_arrivals(seed: int, n: int, vocab: int, max_width: int, long_max: int) -> list:
    """The reference ``heavy_tail`` mix (arrival times, budgets, prompts)
    with the first requests' prompts redrawn, one per pow2 prefill bucket
    from 2 to ``max_width`` (a length inside the bucket, so most are
    left-padded).  The mix's own prompts (median 8, at most 64) never reach
    the wide buckets; this covers every width the kernel serves.  It is a
    smoke run's coverage, not a sourced traffic mix."""
    from repro_torch.runtime import traffic

    widths = [2 ** k for k in range(1, max_width.bit_length())]
    if len(widths) > n:
        raise ValueError(f"{n} requests cannot cover the {len(widths)} buckets up to {max_width}")
    rng = np.random.default_rng(seed)
    arrivals = traffic.heavy_tail(seed, n=n, long_max=long_max, vocab=vocab)
    for i, w in enumerate(widths):
        n_prompt = int(rng.integers(w // 2 + 1, w + 1))
        prompt = rng.integers(2, vocab, size=max(2, n_prompt)).astype(np.int32)
        arrivals[i] = dataclasses.replace(arrivals[i], prompt=prompt)
    return arrivals


def serve_main_path(device, cfg, *, capacity: int, max_batch: int, n_requests: int,
                    max_width: int, seed: int = SEED, long_max: int = 64,
                    init_seed: int = 0) -> dict:
    """Serve the smoke mix through the continuous server, then the same
    requests one at a time (gang mode, batch 1).  Returns counts, metrics
    and the divergences; raises if a request overran its budget, a sync
    went missing or a prefill bypassed the kernel."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_loop, traffic

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(init_seed)
    params = M.init_params(cfg, gen, device=device)
    arrivals = smoke_arrivals(seed, n_requests, cfg.vocab_size, max_width, long_max)
    fetches = {"n": 0}
    real_fetch = serve_loop._host_fetch

    def counted_fetch(x):
        fetches["n"] += 1
        return real_fetch(x)

    serve_loop._host_fetch = counted_fetch
    try:
        srv = serve_loop.BatchedServer(params, cfg, capacity=capacity, eos_id=-1,
                                       mode="continuous", settings={"max_batch": max_batch},
                                       device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        kernel.flash_attention.launches = 0          # counts of the main path only
        t0 = time.perf_counter()
        metrics = traffic.replay(srv, arrivals)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel.flash_attention.launches
        fetches_continuous = fetches["n"]
    finally:
        serve_loop._host_fetch = real_fetch

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
    if device.type == "cuda" and launches != srv.prefill_calls * cfg.n_layers:
        raise AssertionError(f"flash-attention kernel launched {launches} times for "
                             f"{srv.prefill_calls} prefills x {cfg.n_layers} layers")

    # gang at batch 1 is the sequential reference: each request alone, at its
    # own prompt width (a wider gang batch pads every member to its widest)
    gang = serve_loop.BatchedServer(params, cfg, capacity=capacity, eos_id=-1, mode="gang",
                                    settings={"max_batch": 1}, device=device)
    traffic.replay(gang, arrivals)
    cont_s, gang_s = _streams(srv), _streams(gang)
    divergences = []
    for rid, a in enumerate(arrivals):
        s_c, s_g = cont_s[rid], gang_s[rid]
        if s_c == s_g:
            continue
        t = next(i for i, (x, y) in enumerate(zip(s_c, s_g)) if x != y)
        gap = _top2_gap(params, cfg, a.prompt, widths[rid], s_c[:t], capacity, device)
        divergences.append({"rid": rid, "step": t, "top2_gap": gap})
    return {"metrics": metrics, "wall_s": wall, "launches": launches,
            "prefill_calls": srv.prefill_calls, "host_fetches": fetches_continuous,
            "widths": widths, "identical_share": 1.0 - len(divergences) / len(arrivals),
            "divergences": divergences, "params": params, "arrivals": arrivals}


def phase_serve(device, card: str) -> dict:
    from repro_torch.configs import get_config

    cfg = get_config("olmo-1b")
    out = serve_main_path(device, cfg, capacity=2048, max_batch=8, n_requests=16, max_width=1024)
    m = out["metrics"]
    print(f"serve: olmo-1b full width ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f} B params, bf16) on {card}")
    print(f"serve: {int(m['completed'])} requests, widths {sorted(set(out['widths']))}, "
          f"{int(m['total_tokens'])} tokens, {int(m['decode_steps'])} decode steps, "
          f"{out['host_fetches']} host fetches, {out['prefill_calls']} prefills, "
          f"{out['launches']} flash-attention launches")
    print(f"serve: smoke reading, one cold run: continuous tokens_per_s {m['tokens_per_s']:.2f}, "
          f"p50_latency_s {m['p50_latency_s']:.4f}, p99_latency_s {m['p99_latency_s']:.4f} "
          f"({card})")
    print(f"serve: gang vs continuous identical token streams: "
          f"{out['identical_share']:.3f} of requests")
    for d in out["divergences"]:
        print(f"serve: divergence rid {d['rid']} at step {d['step']}: "
              f"top-2 logit gap at batch 1 {d['top2_gap']:.4g}")
    if out["divergences"]:
        print("serve: (reported, not a gate: in bf16 a decode step at batch 8 and one at "
              "batch 1 round differently; the f32 serve in the model phase must agree)")
    return out


# -------------------------------------------------------------------- model
def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_model(device) -> float:
    """Reduced OLMo-1B in float32: card (kernel path) vs CPU (plain path),
    prefill of a non-pow2 prompt (ragged kernel tiles) + 3 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("olmo-1b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 24)))
    fed = torch.from_numpy(rng.integers(2, cfg.vocab_size, (3, 2)))   # decode inputs

    def run(dev):
        p = _to(params, dev)
        logits, caches, pos = M.prefill(p, cfg, toks.to(dev), 32)
        outs = [logits]
        for tok in fed.to(dev):
            logits, caches = M.decode_step(p, cfg, tok, caches, pos)
            pos += 1
            outs.append(logits)
        return [o.cpu() for o in outs]

    worst = 0.0
    for got, want in zip(run(device), run("cpu")):
        if got.shape != (2, cfg.padded_vocab) or not torch.isfinite(got).all():
            raise AssertionError(f"logits of shape {tuple(got.shape)}, "
                                 f"finite {bool(torch.isfinite(got).all())}")
        worst = max(worst, (got - want).abs().max().item())
    if worst > 1e-4:
        raise AssertionError(f"reduced olmo-1b on the card vs the CPU: max abs logit err {worst}")
    print(f"model: reduced olmo-1b f32 prefill (S=24) + 3 decode steps, card vs CPU: "
          f"max abs logit err {worst:.3g} (tol 1e-4)")

    # In f32 the continuous server must reproduce the one-at-a-time streams
    # on the card too; only an argmax near-tie (top-2 gap under the 1e-4
    # logit tolerance above) may differ.
    out = serve_main_path(device, cfg, capacity=64, max_batch=4, n_requests=8, max_width=32,
                          long_max=16)
    ties = [d for d in out["divergences"] if d["top2_gap"] >= 1e-4]
    if ties:
        raise AssertionError(f"f32 continuous vs sequential streams differ beyond near-ties: {ties}")
    print(f"model: reduced olmo-1b f32 served on the card: {out['prefill_calls']} prefills, "
          f"{out['launches']} kernel launches, identical streams "
          f"{out['identical_share']:.3f} of requests (near-ties {len(out['divergences'])})")
    return worst


# ------------------------------------------------------------------ profile
def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def phase_profile(device, serve: dict, card: str, top: int = 8) -> None:
    """The main path's requests again on warm servers: once plain (warm
    tokens/s and p50; the first run paid cuBLAS and allocator set-up), once
    under torch.profiler for the device's busy share and the kernels that
    take its time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.runtime import serve_loop, traffic

    cfg = get_config("olmo-1b")

    def serve_once():
        srv = serve_loop.BatchedServer(serve["params"], cfg, capacity=2048, eos_id=-1,
                                       settings={"max_batch": 8}, device=device)
        m = traffic.replay(srv, serve["arrivals"])
        torch.cuda.synchronize()
        return m

    m = serve_once()
    print(f"profile: warm rerun tokens_per_s {m['tokens_per_s']:.2f}, "
          f"p50_latency_s {m['p50_latency_s']:.4f} ({card})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve_once()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler recorded no device activity")
        return
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = _busy_us(spans)
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    print(f"profile: device busy {busy / 1e3:.1f} ms of a {window / 1e3:.1f} ms window "
          f"(idle share {1 - busy / window:.3f}, profiler on), {len(kernels)} device ops")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"profile: {us / total:6.3f} of device time, {us / 1e3:8.2f} ms  {name[:90]}")


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


def attention_bound_ms(b: int, s: int, h: int, kh: int, d: int, elem_bytes: int,
                       peak_flops: float) -> tuple:
    """Least time for causal attention at these shapes: q, k, v read once and
    o written once, against 4·d FLOPs per unmasked (q, k) pair."""
    bytes_moved = elem_bytes * d * (2 * b * s * h + 2 * b * s * kh)
    flops = 4.0 * d * b * h * s * (s + 1) / 2
    t_bytes, t_flops = bytes_moved / PEAK_BYTES, flops / peak_flops
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def phase_timing(device) -> dict:
    kernel, ref = _import_port()
    case = (1, 1024, 1024, 16, 16, 128, 0, 0)
    q, k, v = _qkv(case, torch.bfloat16, device, seed=7)
    n0 = kernel.flash_attention.launches
    kernel_ms = _time_ms(lambda: kernel.flash_attention(q, k, v, causal=True))
    plain_ms = _time_ms(lambda: ref.naive_attention(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    kernel.flash_attention.launches = n0     # timing launches are not the main path's
    bound_ms, bound_by = attention_bound_ms(1, 1024, 16, 16, 128, 2, PEAK_BF16_FLOPS)
    print(f"timing: flash_attention bf16 B1 S1024 H16 D128 causal: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    _import_port()
    card = phase_card()
    phase_build()
    errs = phase_kernels(device)
    serve = phase_serve(device, card)
    phase_model(device)
    timing = phase_timing(device)
    phase_profile(device, serve, card)
    line = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
        "launches": serve["launches"],
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_dtype": errs,
        "ms": timing["ms"],
        "kernel_ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "shape": "bf16 B1 S1024 H16 K16 D128 causal",
        "card": card,
    }]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
