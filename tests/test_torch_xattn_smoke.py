"""``chip_smoke.py``'s encoder-decoder and VLM phases rehearsed on the CPU at
reduced size (serve-encdec, serve-vlm, model-xattn, train-encdec), its
launch and FLOP accounting for the two families, the kernels phase's cover
of every attention shape those phases give the kernel (with its causal
flag), and the train phase's in-memory continuation beside the resumed
run.  chip_smoke imports nothing of JAX; neither does this file."""
from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import compilecache

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("seamless-m4t-medium", "llama-3.2-vision-11b")


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


def test_attention_calls_and_launches_per_prefill(chip_smoke):
    seamless, vlm = (get_config(n) for n in NAMES)
    assert chip_smoke.attention_passes(seamless) == 12 + 2 * 12
    assert chip_smoke.attention_passes(vlm) == 40 + 8
    assert chip_smoke.attention_passes(get_config("olmo-1b")) == 16
    assert chip_smoke.attention_passes(get_config("mamba2-780m")) == 0
    assert chip_smoke._expected_launches(vlm, 3) == {"flash_attention": 144, "ssd": 0,
                                                     "rmsnorm": 0}
    assert chip_smoke._expected_launches(get_config("hymba-1.5b"), 2) == {
        "flash_attention": 64, "ssd": 64, "rmsnorm": 0}


def test_train_flops_count_the_encoder_and_the_cross_attention(chip_smoke):
    cfg = get_config("seamless-m4t-medium")
    per_query = 12.0 * cfg.n_heads * cfg.hd
    want = (6.0 * cfg.active_param_count() * 4 * 1024
            + per_query * (cfg.n_layers * 4 * 1024 * 1024 / 2          # decoder self, causal
                           + cfg.enc_layers * 4 * 1024 * 1024          # encoder over the frames
                           + cfg.n_layers * 4 * 1024 * 1024))          # cross over the frames
    assert chip_smoke.train_flops(cfg, 4, 1024, frames=1024) == pytest.approx(want)
    vlm = get_config("llama-3.2-vision-11b")
    assert chip_smoke.train_flops(vlm, 1, 64) == pytest.approx(
        6.0 * vlm.active_param_count() * 64 + 12.0 * vlm.n_heads * vlm.hd
        * (40 * 64 * 64 / 2 + 8 * 64 * 1601))


@pytest.mark.parametrize("name", NAMES)
def test_model_xattn_path_on_cpu(chip_smoke, name):
    """The phase's body on the CPU against itself: every output compared,
    finite, no kernel launched (a CPU tensor never reaches one)."""
    out = chip_smoke.model_xattn_path("cpu", name)
    assert set(out["errs"]) == {"forward", "prefill 24", "prefill 2"}
    assert max(out["errs"].values()) == 0.0
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}
    assert out["cfg"].n_layers == (4 if out["cfg"].family == "vlm" else 2)
    assert out["frames"] == (8 if out["cfg"].family == "vlm" else chip_smoke.XATTN_REDUCED_MODAL)


@pytest.mark.parametrize("name", NAMES)
def test_serve_xattn_path_on_cpu(chip_smoke, name):
    """serve-encdec / serve-vlm's body (``serve_main_path``) on a reduced
    config: every request within budget, one fetch per sync, no launch."""
    cfg = get_config(name).reduced()
    out = chip_smoke.serve_main_path("cpu", cfg, capacity=64, max_batch=4, n_requests=8,
                                     max_width=32, long_max=8, divergences=False)
    assert int(out["metrics"]["completed"]) == 8
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}
    assert out["captures"] == 0 and out["prefill_calls"] == 8


def test_train_twice_path_with_frames_on_cpu(chip_smoke):
    """train-encdec's body on reduced seamless: both runs the same bits,
    the frames in every batch."""
    cfg = get_config("seamless-m4t-medium").reduced()
    out = chip_smoke.train_twice_path("cpu", cfg, batch=2, seq=16, steps=2, frames=16,
                                      label="train-encdec")
    a, b = (run["rows"] for run in out["runs"])
    assert [(r["loss"], r["grad_norm"]) for r in a] == [(r["loss"], r["grad_norm"]) for r in b]
    assert all(math.isfinite(r["loss"]) for r in a)
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}


def test_the_continued_run_equals_the_resumed_one_on_cpu(chip_smoke, tmp_path):
    """The train phase's C2 print, rehearsed: reduced OLMo-1B resumed from
    its checkpoint and continued in memory give the same bits."""
    cfg = get_config("olmo-1b").reduced()
    out = chip_smoke.train_main_path("cpu", cfg, batch=2, seq=32, steps=3, resume_to=5,
                                     ckpt_every=3, ckpt_dir=tmp_path, continued=True)
    resumed = {r["step"]: r for r in out["runs"][1]["rows"]}
    assert [r["step"] for r in out["continued"]] == [3, 4]
    for r in out["continued"]:
        assert (r["loss"], r["grad_norm"]) == (resumed[r["step"]]["loss"],
                                               resumed[r["step"]]["grad_norm"])


def test_chip_smoke_checks_every_attention_shape_of_the_xattn_phases(chip_smoke, monkeypatch):
    """The kernels phase holds flash attention against its plain version,
    causal flag included, at every shape the new phases give it: the serve
    phases' (reduced configs served at the phases' capacity, the shapes
    widened to the published heads, a VLM's source to its 1601 tokens),
    train-encdec's (a reduced forward at its batch, sequence and frames)
    and model-xattn's (as they are)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import model as M

    seen, real = [], ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                     kw["window"], kw["q_offset"], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    checked = set(chip_smoke.ATTN_CASES)
    for name in NAMES:
        chip_smoke.model_xattn_path("cpu", name)
    assert seen and set(seen) <= checked, sorted(set(seen) - checked)
    for name in NAMES:
        seen.clear()
        small, full = get_config(name).reduced(), get_config(name)
        chip_smoke.serve_main_path("cpu", small, capacity=chip_smoke.XATTN_CAPACITY,
                                   max_batch=8, n_requests=16, max_width=1024, long_max=4,
                                   divergences=False)
        widened = {(b, sq, full.num_modal_tokens if sk == small.num_modal_tokens and not c
                    else sk, full.n_heads, full.n_kv_heads, full.hd, w, o, c)
                   for b, sq, sk, _, _, _, w, o, c in seen}
        assert sorted({s[1] for s in seen}) == list(chip_smoke.SERVE_WIDTHS)
        assert widened <= checked, sorted(widened - checked)
        assert {s[2] for s in widened if not s[8]} == {chip_smoke.XATTN_MODAL[name]}
    seen.clear()
    small, full = get_config("seamless-m4t-medium").reduced(), get_config("seamless-m4t-medium")
    b, s = chip_smoke.XATTN_TRAIN
    params = M.init_params(small, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        M.forward(params, small, torch.zeros((b, s), dtype=torch.long),
                  torch.zeros((b, s, small.d_model)))
    widened = {(bb, sq, sk, full.n_heads, full.n_kv_heads, full.hd, w, o, c)
               for bb, sq, sk, _, _, _, w, o, c in seen}
    assert widened <= checked, sorted(widened - checked)


def test_the_xattn_reduced_configs(chip_smoke):
    vlm = chip_smoke.xattn_reduced("llama-3.2-vision-11b")
    assert vlm.n_layers // vlm.cross_attn_period == 2
    assert dataclasses.asdict(chip_smoke.xattn_reduced("seamless-m4t-medium")) == \
        dataclasses.asdict(get_config("seamless-m4t-medium").reduced())
