"""The comparison that decides ``correct``, driven through a whole run at a
size a CPU holds (:mod:`perfbench.tests.tiny`), the chip's look skipped:
a sound run is correct; the control (the reference with float8 products)
put in the program's place, and each fault the cell can have, planted in
the timed path, are not.

Limits here are for the tiny size in float32, set the way the cells' own
are, from readings on seeds 1-3: serving gaps of sound runs 0, of the
control 0.38-2.40; training gaps of sound runs under 1e-5, the first
gradient's difference 0.38-0.41 for the control and 0.81-0.90 for a half
batch.
"""
import pytest
import torch

from perfbench.run import run_cell
from perfbench.tests.tiny import tiny_run
from perfbench.tools import faults

SERVE = ["olmo-1b.chat-backlog", "olmo-1b.chat-paced", "olmoe-1b-7b.chat-backlog"]
TRAIN = "olmo-1b.train-8x2048"
SERVE_LIMITS = {"gap": 0.1}
TRAIN_LIMITS = {"grad_diff": 0.1, "change": 0.005}


@pytest.fixture(autouse=True)
def _fresh_registry():
    from repro_torch.core import compilecache

    torch.set_num_threads(2)
    compilecache.clear_registry()
    yield
    compilecache.clear_registry()


def run(cell, limits, control=False):
    r = tiny_run(cell, seed=1)
    r.spec.cell["check"]["limits"] = dict(limits)
    return run_cell(r, control=control)


@pytest.mark.parametrize("cell", SERVE)
def test_serve_sound_run_is_correct_and_its_control_is_not(cell):
    out = run(cell, SERVE_LIMITS, control=True)
    assert out["correct"], out["check"]
    assert out["stand_ins"]["control"]["correct"] is False, out["stand_ins"]
    assert out["readings"]["tokens"] >= 8


@pytest.mark.parametrize("cell", SERVE)
def test_serve_token_altered_where_produced(cell, monkeypatch):
    monkeypatch.setattr(*faults.token_altered())
    out = run(cell, SERVE_LIMITS)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell", SERVE)
def test_serve_decode_step_that_leaves_its_state_unchanged(cell, monkeypatch):
    monkeypatch.setattr(*faults.cache_unchanged())
    out = run(cell, SERVE_LIMITS)
    assert not out["correct"], out["check"]


def test_train_sound_run_is_correct_and_its_control_and_half_batch_are_not():
    out = run(TRAIN, TRAIN_LIMITS, control=True)
    assert out["correct"], out["check"]
    for fault in ("control", "half_batch"):
        assert out["stand_ins"][fault]["correct"] is False, (fault, out["stand_ins"])


def test_train_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.runtime import steps

    def unchanged(grads, state, params, **kw):
        return params, {"m": state["m"], "v": state["v"], "count": state["count"] + 1}, \
            {"grad_norm": torch.zeros(())}

    monkeypatch.setattr(steps, "adamw_update", unchanged)
    out = run(TRAIN, TRAIN_LIMITS)
    assert not out["correct"]
    assert out["check"]["change"]["value"] == pytest.approx(1.0)


def test_train_half_of_the_batch_left_out(monkeypatch):
    from repro_torch.runtime import steps

    real = steps._value_and_grad

    def half(cfg, params, batch):
        rows = batch["tokens"].shape[0] // 2
        return real(cfg, params, {k: v[:rows] for k, v in batch.items()})

    monkeypatch.setattr(steps, "_value_and_grad", half)
    out = run(TRAIN, TRAIN_LIMITS)
    assert not out["correct"], out["check"]

