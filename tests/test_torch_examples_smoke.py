"""chip_smoke.py's figures, cold-warm, examples and grid phases rehearsed on
the CPU at reduced size, and the SSD and autotune shapes the examples give
a kernel held to the kernels phase's cases.

The phases' functions take a device, so their control flow and gates run
here before they reach the card: the figures at a small budget, sweep and
grid; the cold/warm phase through the runner's CLI with its children stood
in, and the background plumbing that runs it and the fault phase beside
other phases; the examples at their smoke sizes;
the ``training`` and ``demo`` grids through the generic grid path.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from torch_threads import one_thread_here_and_in_children

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Reduced models on a CPU shared with the other test workers: one
    intra-op thread here and in the interpreters the tests start."""
    with one_thread_here_and_in_children():
        yield


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_examples", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small_figures(monkeypatch):
    from repro_torch.bench import fig4_counters, fig5_spinlock

    monkeypatch.setattr(fig4_counters, "SWEEP", [9, 12, 16])
    monkeypatch.setattr(fig5_spinlock, "HEAVY", [1, 16])
    monkeypatch.setattr(fig5_spinlock, "GRID", [1, 100, 10000])


def test_figures_phase_on_cpu(chip_smoke, tmp_path, small_figures):
    """fig3 with the BO arms on the torch engine, fig4 and fig5 at reduced
    sizes, and the demo grid: the phase's gates pass and the claims print."""
    out = chip_smoke.figures_path("cpu", tmp_path, budget=3)
    assert {"fig3", "fig4", "fig5", "demo"} <= set(out)
    assert all(len(t) == 3 for r in out["fig3"].values() for t in r["traces"].values())
    assert [r["log2_buckets"] for r in out["fig4"]["rows"]] == [9, 12, 16]
    assert set(out["fig5"]["workloads"]) == {"1", "16"}
    assert out["demo"]["measure_calls"] > 0 and out["demo"]["entries"] >= 1
    lines = chip_smoke.claims(out)
    assert [line[:2] for line in lines].count("C1") == 2
    assert {line[:2] for line in lines} == {"C1", "C2", "C3", "C4", "C5", "C6"}
    for name in ("fig3_hashtable", "fig4_counters", "fig5_spinlock"):
        assert (tmp_path / f"{name}.json").exists()


def test_figures_phase_fails_on_a_rising_trace(chip_smoke, tmp_path, small_figures,
                                               monkeypatch):
    from repro_torch.bench import fig3_hashtable

    real = fig3_hashtable.run

    def broken(*a, **kw):
        res = real(*a, **kw)
        res["OpenRowSet"]["traces"]["random"][-1] += 1.0
        return res

    monkeypatch.setattr(fig3_hashtable, "run", broken)
    with pytest.raises(AssertionError, match="fig3 OpenRowSet random"):
        chip_smoke.figures_path("cpu", tmp_path, budget=3)


def _fake_children(launches):
    """Stand-in for the twin's fresh interpreters: cold children take 10 s
    and build a library, warm ones 1 s; each launched ``launches`` kernels."""
    def children(plan, device):
        cold = len(plan) // 2
        return [{"first_step_s": 10.0 + 0.1 * i if i < cold else 1.0 + 0.01 * i,
                 "loss": 1.0, "counters": {"hits": 0, "misses": 1}, "build_dir": str(root),
                 "libraries": ["flash_attention.so"] if i <= cold else [],
                 "launches": launches, "device": device} for i, root in enumerate(plan)]
    return children


class _Ran:
    """A background twin that has already ended: its runner ran in this
    process into ``dir``."""

    def __init__(self, d, runner_argv):
        from repro_torch.bench import runner

        self.dir, self.t0 = d, 0.0
        self.stopped = False
        assert runner.main(runner_argv) == 0

    def finish(self, label):
        return 0.0

    def stop(self):
        self.stopped = True


@pytest.mark.parametrize("launches", [32, 0])
def test_cold_warm_phase_on_cpu(chip_smoke, tmp_path, monkeypatch, launches):
    """The phase's runner arguments through the runner's own CLI with the
    twin's children stood in (the real ones are fresh interpreters, whose
    plumbing tests/test_torch_cold_warm.py holds): the quick twin's 6 a side
    and its check pass, the phase's gates read the JSON, and a child that
    launched no kernel fails the phase."""
    from repro_torch.bench import compile_cold_warm

    monkeypatch.setattr(compile_cold_warm, "_children", _fake_children(launches))
    args = chip_smoke.runner_args("compile_cold_warm", tmp_path, quick=True)
    twin = _Ran(tmp_path, args + ["--device", "cpu"])
    if launches == 0:
        with pytest.raises(AssertionError, match="launched no attention kernel"):
            chip_smoke.phase_cold_warm(twin, "cpu")
        assert twin.stopped
        return
    res = chip_smoke.phase_cold_warm(twin, "cpu")
    assert twin.stopped
    assert len(res["cold_s"]) == len(res["warm_s"]) == 6 and res["quick"] is True
    assert res["verdict"]["verdict"] == "improved" and res["roots_removed"]
    assert res["path_launches"]["flash_attention"] == 13 * launches
    assert (tmp_path / "trajectory.jsonl").exists()


@pytest.mark.slow
def test_background_prints_its_output_and_stops_its_process_group(chip_smoke, tmp_path,
                                                                   capsys):
    """The background plumbing of the cold-warm and fault phases on trivial
    commands: the output printed under the label, a non-zero exit raised
    with its errors, and a command's own child killed with it."""
    import sys
    import time

    def alive(pid):
        """A process that has not ended (a zombie waiting for its reaper has)."""
        try:
            status = Path(f"/proc/{pid}/status").read_text()
        except FileNotFoundError:
            return False
        return "\nState:\tZ" not in status

    ok = tmp_path / "ok"
    ok.mkdir()
    bg = chip_smoke.Background([sys.executable, "-c", "print('hello')"], ok, timeout=60.0)
    assert bg.finish("label") >= 0.0
    assert "label: hello" in capsys.readouterr().out
    bg.stop()
    assert not ok.exists() and bg not in chip_smoke._BACKGROUND

    bad = tmp_path / "bad"
    bad.mkdir()
    bg = chip_smoke.Background([sys.executable, "-c", "import sys; sys.exit('broken')"], bad,
                               timeout=60.0)
    with pytest.raises(AssertionError, match="exited 1:\n.*broken"):
        bg.finish("label")
    assert not bad.exists()

    hang = tmp_path / "hang"
    hang.mkdir()
    pid_file = tmp_path / "grandchild.pid"
    code = ("import subprocess, sys, time; "
            "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(600)']); "
            f"open({str(pid_file)!r}, 'w').write(str(p.pid)); time.sleep(600)")
    bg = chip_smoke.Background([sys.executable, "-c", code], hang, timeout=60.0)
    for _ in range(400):
        if pid_file.exists() and pid_file.read_text():
            break
        time.sleep(0.05)
    grandchild = int(pid_file.read_text())
    assert alive(grandchild)
    chip_smoke.stop_background()
    assert bg.proc.poll() is not None and not chip_smoke._BACKGROUND and not hang.exists()
    for _ in range(100):                     # killed with its group
        if not alive(grandchild):
            break
        time.sleep(0.05)
    else:
        raise AssertionError("the command's own child outlived stop_background")


@pytest.mark.slow
def test_examples_phase_on_cpu(chip_smoke, tmp_path):
    """Every example at its smoke size: finite losses, no kernel launch on
    the CPU, the daemon's report and exit, a resume that measures nothing,
    and a warm start that beats the cold cell."""
    out = chip_smoke.examples_path("cpu", tmp_path)
    assert set(out) == set(chip_smoke.EXAMPLES)
    assert all(o["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}
               for o in out.values())
    assert out["autotune_kernels"]["result"]["agent_exitcode"] == 0
    cq = out["campaign_quickstart"]["result"]
    assert cq["resume_measure_calls"] == 0 and cq["warm_evals"] < cq["cold_evals"]


@pytest.mark.parametrize("grid", ["training", "demo"])
def test_the_new_grids_on_cpu(chip_smoke, grid):
    """The grids the train and figures phases run: every cell done and
    resumable, entries under this process's fingerprint."""
    resolve = (chip_smoke.instance_settings if grid == "training"
               else chip_smoke.new_instance_settings)
    out = chip_smoke.grid_path("cpu", grid, budget=4, campaign_id=f"smoke-{grid}",
                               resolve=resolve)
    assert len(out["results"]) == (3 if grid == "training" else 5)
    assert out["measure_calls"] > 0
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}


def test_the_settings_grids_resolve_through_the_running_instance(chip_smoke, monkeypatch,
                                                                  tmp_path):
    """The serving and training grids' gate reads what the runtime runs with:
    the running instance's explicit keys outrank the store, as they do for
    the server; the demo grid's reads what a new table or lock without keys
    of its own resolves."""
    from repro_torch.core import configstore, smartcomponents  # noqa: F401 — registers them
    from repro_torch.core.registry import get_component
    from repro_torch.runtime import serve_loop

    srv, wl = serve_loop.serve_settings, "reduced_c128"
    monkeypatch.setattr(srv, "settings", dict(srv.settings))
    monkeypatch.setattr(srv, "_explicit_settings", set(srv._explicit_settings))
    old = configstore.set_default_store(configstore.ConfigStore(tmp_path / "store"))
    try:
        assert chip_smoke.instance_settings("torch_serve_batching", wl) == srv.settings_for(wl)
        other = 16 if srv.settings_for(wl)["max_batch"] != 16 else 8
        srv.apply_settings({"max_batch": other})
        assert chip_smoke.instance_settings("torch_serve_batching", wl)["max_batch"] == other
        assert chip_smoke.new_instance_settings("torch_hashtable", "n1024l2") == \
            get_component("torch_hashtable").space.defaults()
    finally:
        configstore.set_default_store(old)


def test_chip_smoke_checks_the_ssd_and_autotune_shapes_of_the_examples(chip_smoke, tmp_path,
                                                                     monkeypatch):
    """The kernels phase holds the SSD scan against its plain version at the
    shape train_lm's smoke preset gives it on reduced mamba2-780m (recorded
    here; the reduced config is the card's too), and flash attention at
    autotune_kernels' shape at every compiled tile pair.  (The examples'
    other attention shapes are held in tests/test_torch_isolation.py.)"""
    from repro_torch.examples import autotune_kernels, train_lm
    from repro_torch.kernels.ssd import ops as ssd_ops

    seen_ssd, real_ssd = [], ssd_ops.ssd

    def ssd_spy(x, dt, A, B, C, *a, **kw):
        seen_ssd.append((x.shape[0], x.shape[1], x.shape[2], x.shape[3], B.shape[3], B.shape[2]))
        return real_ssd(x, dt, A, B, C, *a, **kw)

    monkeypatch.setattr(ssd_ops, "ssd", ssd_spy)
    train_lm.main(["--device", "cpu", "--steps", "1", "--arch", "mamba2-780m",
                   "--ckpt-dir", str(tmp_path / "b")])
    assert seen_ssd and set(seen_ssd) <= set(chip_smoke.SSD_CASES), \
        sorted(set(seen_ssd) - set(chip_smoke.SSD_CASES))
    s = autotune_kernels.SHAPE
    assert [(s["b"], s["s"], s["s"], s["h"], s["k"], s["d"], 0, 0, True)] == \
        chip_smoke.ATTN_AUTOTUNE_CASES
