"""The port's examples (``repro_torch.examples``), each run through its
``main`` on the CPU, asked for explicitly, at its smoke size: the
reference's ``examples/`` sizes.  Each one defaults to the card and
refuses a card that is not there rather than running on the CPU.
"""
from __future__ import annotations

import importlib
import inspect
import math

import pytest
import torch

from repro_torch.examples import (autotune_kernels, campaign_quickstart, quickstart,
                                  serve_decode, train_lm)
from repro_torch.kernels.flash_attention import ops as attn_ops
from torch_threads import one_thread_here_and_in_children

NAMES = ("quickstart", "train_lm", "serve_decode", "autotune_kernels", "campaign_quickstart")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Reduced models on a CPU shared with the other test workers: one
    intra-op thread here and in the interpreters the tests start."""
    with one_thread_here_and_in_children():
        yield


def test_quickstart_tunes_lr_scale_of_a_live_train_job():
    out = quickstart.main(["--device", "cpu"])
    assert len(out["losses"]) == 30 and all(math.isfinite(x) for x in out["losses"])
    assert out["losses"][-1] < out["losses"][0]
    # one experiment per 5 steps, the first at the reference's starting scale
    assert len(out["tried"]) == 6 and out["tried"][0]["lr_scale"] == 1.0
    assert len({t["lr_scale"] for t in out["tried"]}) > 1
    assert 0.25 <= out["best_config"]["lr_scale"] <= 4.0
    assert out["best_value"] == min(t["avg_loss"] for t in out["tried"])


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-780m", "olmoe-1b-7b"])
def test_train_lm_smoke_preset_trains_and_resumes(arch, tmp_path):
    out = train_lm.main(["--device", "cpu", "--arch", arch, "--ckpt-dir", str(tmp_path)])
    assert (out["n_steps"], out["global_batch"], out["seq_len"]) == (20, 8, 64)
    assert len(out["losses"]) == 20 and all(math.isfinite(x) for x in out["losses"])
    again = train_lm.main(["--device", "cpu", "--arch", arch, "--ckpt-dir", str(tmp_path)])
    assert again["losses"] == []           # the last step is checkpointed: nothing to train


def test_train_lm_presets_are_the_references():
    from examples import train_lm as ref

    for arch in ("olmo-1b", "mamba2-780m", "olmoe-1b-7b", "hymba-1.5b"):
        ref_cfg, ref_kw = ref.preset_config(arch, "cpu-smoke")
        cfg, kw = train_lm.preset_config(arch, "smoke")
        assert kw == ref_kw and cfg.param_count() == ref_cfg.param_count()
        ref_cfg, ref_kw = ref.preset_config(arch, "100m")
        cfg, kw = train_lm.preset_config(arch, "100m")
        assert kw == ref_kw and cfg.param_count() == ref_cfg.param_count()
    with pytest.raises(ValueError, match="unknown preset"):
        train_lm.preset_config("olmo-1b", "cpu-smoke")


def test_serve_decode_tunes_the_batch_size_by_tokens_per_s():
    out = serve_decode.main(["--device", "cpu"])
    trials = out["trials"]
    assert len(trials) == 6 and all(1 <= t["max_batch"] <= 16 for t in trials)
    assert all(t["tokens"] > 0 and t["tokens_per_s"] > 0 for t in trials)
    assert all(t["prefills"] == 24 for t in trials)
    assert out["best_tokens_per_s"] in [t["tokens_per_s"] for t in trials]
    assert all(t["tokens_per_s"] <= out["best_tokens_per_s"] for t in trials)


@pytest.mark.slow
def test_autotune_kernels_spawned_agent_reports_and_exits():
    """The full Figure 2 deployment: a spawned daemon over the shared-memory
    channel; the process-wide attention settings stay untouched."""
    before = attn_ops.attention_settings.settings_for("*")
    out = autotune_kernels.main(["--device", "cpu"])
    assert out["agent_exitcode"] == 0
    rep = out["report"]
    assert rep is not None and rep["evaluations"] == autotune_kernels.BUDGET
    assert rep["best_config"] == out["settings"]
    assert len(out["trace"]) == autotune_kernels.BUDGET
    assert all(t["time_us"] > 0 for t in out["trace"])
    assert attn_ops.attention_settings.settings_for("*") == before


def test_campaign_quickstart_resumes_and_warm_starts(tmp_path):
    out = campaign_quickstart.main(["--device", "cpu", "--store", str(tmp_path / "s"),
                                    "--journal-root", str(tmp_path / "j")])
    assert out["first"] and all(out["first"].values())
    assert out["resume_measure_calls"] == 0
    assert out["warm_start"]["source_workload"] in campaign_quickstart.GRID
    assert out["warm_evals"] < out["cold_evals"]
    entries = list((tmp_path / "s").glob("*.json"))
    assert entries and all("cpu:" in e.read_text() for e in entries)


@pytest.mark.parametrize("name", NAMES)
def test_each_example_defaults_to_the_card_and_refuses_a_missing_one(name, monkeypatch,
                                                                      tmp_path):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    assert 'ap.add_argument("--device", default="cuda"' in inspect.getsource(mod.main)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--ckpt-dir", str(tmp_path)] if name == "train_lm" else [])


def test_agent_core_direct_observation_matches_the_reference():
    """``AgentCore.ask`` / ``observe_value`` (the examples' in-process
    driver) propose what the reference's do for the same values."""
    import math as m

    from repro.core import AgentCore as RefCore
    from repro.core import make_session as ref_session
    from repro.core.tunable import Float as RefFloat
    from repro.core.tunable import TunableSpace as RefSpace
    from repro_torch.core.agent import AgentCore, make_session
    from repro_torch.core.tunable import Float, TunableSpace

    ref = RefCore(ref_session("train_loop", "loss", packed=False, optimizer="bo_matern32",
                              budget=6, space=RefSpace([RefFloat("lr_scale", 1.0, 0.25, 4.0,
                                                                 log=True)])))
    port = AgentCore(make_session("torch_train_loop", "loss", optimizer="bo_matern32", budget=6,
                                  space=TunableSpace([Float("lr_scale", 1.0, 0.25, 4.0,
                                                            log=True)])))
    assert port.ask() == ref.ask()
    cfg = {"lr_scale": 1.0}
    for _ in range(8):                     # past the budget: both park on their best
        value = (m.log(cfg["lr_scale"]) - 0.3) ** 2
        nxt = ref.observe_value(cfg, value)
        assert port.observe_value(cfg, value) == nxt
        cfg = nxt
    assert port.done and ref.done and port.best.config == ref.best.config
