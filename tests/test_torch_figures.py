"""The paper's Figures 3–5 as the port's twins (``repro_torch.bench.fig3_hashtable``,
``fig4_counters``, ``fig5_spinlock``) held against the reference's
``benchmarks/fig*.py`` on the CPU.

fig5's spinlock is a deterministic simulation: with the numpy backend the
twin's dict equals the reference's exactly, at a reduced ``HEAVY`` and
``GRID`` patched alike into both modules.  fig3 and fig4 time the hash
table on the host's clock, so both modules get one deterministic stand-in
for ``time_samples_us`` (a cost read off the table's own app metrics); the
traces, best configs, verdicts, collisions and memory figures must then
agree.  Nothing here measures a speed.
"""
from __future__ import annotations

import json

import pytest

from benchmarks import fig3_hashtable as ref_fig3
from benchmarks import fig4_counters as ref_fig4
from benchmarks import fig5_spinlock as ref_fig5
from repro.core.tracking import Tracker as RefTracker
from repro_torch.bench import fig3_hashtable, fig4_counters, fig5_spinlock, run as suite
from repro_torch.core.optimizers import optimizer_defaults
from repro_torch.core.tracking import Tracker


def stand_in_samples_us(fn, *args, warmup: int = 1, reps: int = 3):
    """Deterministic 'microseconds': collisions and footprint of the table
    the measured call used, with a fixed 1% spread between samples."""
    m = fn(*args)
    base = 100.0 + float(m["collisions"]) + m["memory_bytes"] / 1e3
    return [base * (1.0 + 0.01 * i) for i in range(max(reps, 1))]


@pytest.fixture
def stand_in_clock(monkeypatch):
    for mod in (ref_fig3, ref_fig4, fig3_hashtable, fig4_counters):
        monkeypatch.setattr(mod, "time_samples_us", stand_in_samples_us)


def test_fig5_numpy_backend_equals_the_reference_exactly(monkeypatch):
    for mod in (ref_fig5, fig5_spinlock):
        monkeypatch.setattr(mod, "HEAVY", [1, 8, 64])
        monkeypatch.setattr(mod, "GRID", [1, 31, 1000, 31622])
    want = ref_fig5.run()
    got = fig5_spinlock.run(backend="numpy", device="cpu")
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got == want
    assert optimizer_defaults()["backend"] == "numpy"   # the run's backend is restored


def test_fig5_keeps_the_reference_constants():
    assert fig5_spinlock.HEAVY == ref_fig5.HEAVY and fig5_spinlock.GRID == ref_fig5.GRID
    assert fig5_spinlock.SEEDS == ref_fig5.SEEDS


def test_fig3_equals_the_reference_under_one_clock(stand_in_clock, tmp_path):
    want = ref_fig3.run(RefTracker(str(tmp_path / "ref")), budget=4)
    got = fig3_hashtable.run(Tracker(tmp_path / "port"), budget=4, backend="numpy",
                             device="cpu")
    assert set(got) == set(want) == set(ref_fig3.INSTANCES)
    for inst, w in want.items():
        g = got[inst]
        assert g["default_host_us"] == w["default_time_us"]
        assert g["traces"] == w["traces"]
        for opt in ref_fig3.OPTIMIZERS:
            gb, wb = g["best"][opt], w["best"][opt]
            assert gb["config"] == wb["config"], (inst, opt)
            assert gb["host_us"] == wb["time_us"]
            assert gb["improvement_pct"] == wb["improvement_pct"]
            assert (gb["verdict"], gb["effect"], gb["p_value"]) == \
                (wb["verdict"], wb["effect"], wb["p_value"])


def test_fig3_keeps_the_reference_setup():
    assert fig3_hashtable.INSTANCES == ref_fig3.INSTANCES
    assert fig3_hashtable.OPTIMIZERS == ref_fig3.OPTIMIZERS
    assert (fig3_hashtable.BUDGET, fig3_hashtable.REPEATS) == (ref_fig3.BUDGET, ref_fig3.REPEATS)


def test_fig4_equals_the_reference_under_one_clock(stand_in_clock, monkeypatch, tmp_path):
    for mod in (ref_fig4, fig4_counters):
        monkeypatch.setattr(mod, "SWEEP", [9, 11, 13, 16, 20])
    want = ref_fig4.run()
    got = fig4_counters.run()
    assert [r["log2_buckets"] for r in got] == [r["log2_buckets"] for r in want]
    for g, w in zip(got, want):
        assert (g["memory_mb"], g["collisions"]) == (w["memory_mb"], w["collisions"])
        assert g["host_us"] == w["time_us"] and g["host_samples_us"] == w["samples_us"]
    res = fig4_counters.write(got, tmp_path)
    fastest = [r["log2_buckets"] for r in want
               if all(r["time_us"] <= o["time_us"] for o in want)]
    assert res["sweet_spot"]["log2_buckets"] == fastest[0]
    assert json.loads((tmp_path / "fig4_counters.json").read_text())["rows"] == \
        json.loads(json.dumps(got))


def test_fig4_keeps_the_reference_sweep():
    assert fig4_counters.SWEEP == ref_fig4.SWEEP == list(range(9, 23))
    assert fig4_counters.WL == ref_fig4.WL


def test_the_twins_name_host_time_as_such(stand_in_clock, tmp_path):
    """No key of the twins' JSON passes a host time off as a device one."""
    res = fig3_hashtable.write(fig3_hashtable.run(Tracker(tmp_path / "r"), budget=2,
                                                  backend="numpy", device="cpu"),
                               tmp_path, backend="numpy", device="cpu")
    text = (tmp_path / "fig3_hashtable.json").read_text()
    assert "time_us" not in text and "host_us" in text
    assert res["OpenRowSet"]["traces"]["random"]


def test_the_figures_refuse_a_missing_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fig3_hashtable.run(budget=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fig5_spinlock.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        suite.suite()


def test_the_suite_runs_every_figure_and_names_the_roofline_as_pending(monkeypatch, tmp_path,
                                                                         capsys):
    """The suite's order and walls, with each benchmark stubbed (each has its
    own test); the reference's roofline table waits for the dry-run layer."""
    from repro_torch.bench import kernel_autotune, multi_instance

    ran = []
    for mod, fn in ((fig3_hashtable, "run"), (fig4_counters, "run"), (fig5_spinlock, "run"),
                    (multi_instance, "run"), (kernel_autotune, "main")):
        monkeypatch.setattr(mod, fn, lambda *a, _m=mod.__name__, **k: ran.append(_m) or {})
    for mod in (fig3_hashtable, fig4_counters, fig5_spinlock):
        monkeypatch.setattr(mod, "write", lambda res, *a, **k: res)
    out = suite.suite(device="cpu", backend="numpy", out_dir=tmp_path)
    assert [m.rsplit(".", 1)[-1] for m in ran] == ["fig3_hashtable", "fig4_counters",
                                                  "fig5_spinlock", "multi_instance",
                                                  "kernel_autotune"]
    assert all(out[k]["wall_s"] >= 0 for k in ("fig3_hashtable", "fig4_counters"))
    assert suite.ROOFLINE_PENDING in capsys.readouterr().out
