"""StarCoder2-15B's windowed dense path served past its window, and
``chip_smoke.py``'s new phases rehearsed on the CPU.

The port's server on reduced starcoder2-15b (the less-reduced config of
tests/test_torch_model.py: head dim 64, GQA 4→2, biases, LayerNorm, GELU, a
16-token window) takes prompts wider than the window and decodes past it,
so every ring buffer wraps; its greedy streams must be the reference
server's, near-ties aside (the f32 logits agree to 1e-4).  Then the
serve-dense-window phase's attention shapes against the kernels phase's
cases, the dryrun-check path at reduced size, and the checks the dryrun
phase applies to the background sweep's files.  No full-size cell is
traced or served here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import types
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.runtime.serve_loop import BatchedServer as JServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core import compilecache
from repro_torch.launch import shapes
from repro_torch.launch.mesh import HW
from repro_torch.models import model as M
from repro_torch.runtime.serve_loop import BatchedServer
from torch_threads import one_thread

ROOT = Path(__file__).resolve().parents[1]
CAPACITY = 64          # prompts keep 32 tokens: twice the 16-token window
NEAR_TIE = 1e-4
WIDE = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def no_handed_over_state():
    yield
    compilecache.drop_handed_over()


@pytest.fixture(scope="module")
def starcoder():
    jcfg = dataclasses.replace(jget_config("starcoder2-15b").reduced(), **WIDE).validate()
    cfg = dataclasses.replace(get_config("starcoder2-15b").reduced(), **WIDE).validate()
    jparams = JM.init_params(jax.random.PRNGKey(zlib.crc32(b"starcoder2-15b") % (1 << 31)), jcfg)
    return params_from_reference(jax.device_get(jparams), cfg, device="cpu"), cfg, jparams, jcfg


def _prompts(n):
    rng = np.random.default_rng(zlib.crc32(b"dense-window"))
    return [rng.integers(2, 250, size=int(k)).astype(np.int32)
            for k in rng.integers(3, 48, size=n)]


def _top2_gap(params, cfg, prompt, width, stream, t):
    toks = np.zeros((1, width), np.int64)
    n = min(len(prompt), width)
    toks[0, -n:] = prompt[-n:]
    logits, caches, pos = M.prefill(params, cfg, torch.from_numpy(toks), CAPACITY)
    for tok in stream[:t]:
        logits, caches = M.decode_step(params, cfg, torch.tensor([tok]), caches, pos)
        pos += 1
    top = logits[0].topk(2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("interval", [1, 4])
def test_the_server_decodes_past_the_window_as_the_references(starcoder, interval):
    params, cfg, jparams, jcfg = starcoder
    assert cfg.window == 16 and CAPACITY // 2 > cfg.window
    settings = {"max_batch": 3, "admission": 2, "prefill_chunk": 16, "sync_interval": interval}
    prompts = _prompts(7)
    srv = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode="continuous",
                        settings=settings, device="cpu")
    ref = JServer(jparams, jcfg, capacity=CAPACITY, eos_id=-1, mode="continuous",
                  settings=settings)
    for p in prompts:
        srv.submit(p)
        ref.submit(p)
    srv.run(max_new_tokens=24)
    ref.run(max_new_tokens=24)
    widths = [srv._width_of(len(p)) for p in prompts]
    assert max(widths) == CAPACITY // 2 and any(w + 24 > 2 * cfg.window for w in widths)
    got = {r.rid: list(r.tokens) for r in srv.results.values()}
    want = {r.rid: list(r.tokens) for r in ref.results.values()}
    assert got.keys() == want.keys() and all(len(s) == 24 for s in got.values())
    for rid, stream in got.items():
        if stream == want[rid]:
            continue
        t = next(i for i, (x, y) in enumerate(zip(stream, want[rid])) if x != y)
        gap = _top2_gap(params, cfg, prompts[rid], widths[rid], stream, t)
        assert gap < NEAR_TIE, f"request {rid} diverges at step {t}, top-2 gap {gap:.3g}"


# ------------------------------------------------------ chip_smoke rehearsals
def test_the_kernels_phase_checks_every_serve_dense_window_prefill(chip_smoke):
    cfg = get_config(chip_smoke.DENSE_WINDOW_NAME)
    checked = {case[:8] for case in chip_smoke.ATTN_CASES if case[8]}
    for w in chip_smoke.DENSE_WINDOW_WIDTHS:
        assert (1, w, w, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window, 0) in checked
    widest = max(chip_smoke.DENSE_WINDOW_WIDTHS)
    assert widest > cfg.window and sorted(chip_smoke.DENSE_WINDOW_WIDTHS) == [
        *(2 ** k for k in range(1, 11)), 8192]
    server = types.SimpleNamespace(capacity=chip_smoke.DENSE_WINDOW_CAPACITY)
    assert BatchedServer._width_of(server, widest) == widest
    b, s, h, kh, d, window = chip_smoke.ATTN_TIMED_WINDOW["starcoder2-15b prefill"]
    assert (h, kh, d, window) == (cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window) and s == widest


def test_the_window_mask_is_the_bands(chip_smoke):
    m = chip_smoke._window_mask(6, 3, "cpu")
    want = torch.tensor([[j <= i and i - j < 3 for j in range(6)] for i in range(6)])
    assert torch.equal(m, want)


def test_the_serve_dense_window_path_on_cpu(chip_smoke, starcoder):
    params, cfg, _, _ = starcoder
    out = chip_smoke.serve_main_path("cpu", cfg, capacity=CAPACITY, max_batch=8, n_requests=6,
                                     max_width=32, widths=[2, 4, 8, 16, 32, 32],
                                     params=params, divergences=False)
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}
    assert max(out["widths"]) == 32 > cfg.window and out["metrics"]["completed"] == 6


@pytest.mark.parametrize("arch", ["starcoder2-15b", "mamba2-780m", "hymba-1.5b"])
def test_the_dryrun_check_path_on_cpu(chip_smoke, arch):
    assert arch in chip_smoke.DRYRUN_CHECK_ARCHS
    shape = shapes.Shape("long_500k", "decode", 4096, 1)
    out = chip_smoke.dryrun_check_path("cpu", arch, cfg=get_config(arch).reduced(), shape=shape)
    rec = out["record"]
    assert rec["status"] == "ok"
    assert rec["per_device_bytes"] > rec["memory"]["argument_size_in_bytes"]
    assert set(out) == {"record"}                 # nothing is measured on the CPU


def _sweep(tmp_path, *, breaking=None, hardware=HW["fingerprint"]):
    (tmp_path / "dryrun").mkdir()
    (tmp_path / "store").mkdir()
    for arch, shape in shapes.all_cells():
        runs, _ = shapes.cell_status(get_config(arch), shapes.SHAPES[shape])
        status = "ok" if runs else "skip"
        if (arch, shape) == breaking:
            status = "error" if runs else "ok"
        (tmp_path / "dryrun" / f"{arch}__{shape}__one.json").write_text(
            json.dumps({"status": status, "fits": True, "mesh": "one"}))
    entry = {"context": {"component": "torch_layer_stack", "workload": "olmo-1b/train_4k/one",
                         "hardware": hardware, "sw": "x"}, "settings": {"remat": "dots"}}
    (tmp_path / "store" / "torch_layer_stack.json").write_text(
        json.dumps({"component": "torch_layer_stack", "entries": [entry]}))
    (tmp_path / "perf.json").write_text(json.dumps(
        {"persisted_contexts": ["torch_layer_stack@olmo-1b/train_4k/one"]}))


def test_the_dryrun_phase_checks_the_sweep_and_the_winners(chip_smoke, tmp_path):
    _sweep(tmp_path)
    out = chip_smoke.check_dryrun(tmp_path)
    assert len(out["records"]) == 40 and len(out["entries"]) == 1


@pytest.mark.parametrize("fault", ["error", "skip_that_runs", "cpu_entry", "missing"])
def test_the_dryrun_phase_fails_on(chip_smoke, tmp_path, fault):
    if fault == "error":
        _sweep(tmp_path, breaking=("olmo-1b", "train_4k"))
    elif fault == "skip_that_runs":
        _sweep(tmp_path, breaking=("olmo-1b", "long_500k"))
    elif fault == "cpu_entry":
        _sweep(tmp_path, hardware="cpu:x86_64:x1")
    else:
        _sweep(tmp_path)
        (tmp_path / "dryrun" / "mamba2-780m__long_500k__one.json").unlink()
    with pytest.raises(AssertionError):
        chip_smoke.check_dryrun(tmp_path)


def test_the_background_sweep_is_host_only(chip_smoke, monkeypatch):
    seen = {}

    class Fake:
        def __init__(self, argv, workdir, *, timeout, env=None):
            seen.update(argv=argv, env=env, timeout=timeout, workdir=workdir)

    monkeypatch.setattr(chip_smoke, "Background", Fake)
    chip_smoke.start_dryrun()
    cmd = seen["argv"][-1]
    assert seen["env"] == {"CUDA_VISIBLE_DEVICES": ""}
    for part in ("-m repro_torch.launch.dryrun --mesh one",
                 "-m repro_torch.launch.roofline", "-m repro_torch.launch.perf --arch olmo-1b "
                 "--shape train_4k --mesh one --patience 3"):
        assert part in cmd
    from repro_torch.configs import ALL_ARCHS

    groups = [a for g in chip_smoke.DRYRUN_GROUPS for a in g]
    assert sorted(groups) == sorted(ALL_ARCHS) and all(f" {a}" in cmd for a in groups)
    Path(seen["workdir"]).rmdir()
