"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
jax and nothing of the reference package ``repro``, never import triton
(the port's kernel is CUDA C++), and never call a library attention.  The
chip smoke script's main-path phase runs here on the CPU at reduced size,
so its control flow is rehearsed before it reaches the card.
"""
import ast
import dataclasses
import importlib.util
import json
import math
import os
import pkgutil
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "triton")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_every_module_imports_without_jax_or_repro():
    """A fresh interpreter imports every module of the port; afterwards no
    jax and no ``repro`` module is loaded."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(_modules()) >= 66


def test_the_ssm_slice_is_covered():
    """The SSD kernel's modules, the SSM mixer and the CUDA source are among
    what the checks here walk."""
    assert {"repro_torch.kernels.ssd.ref", "repro_torch.kernels.ssd.kernel",
            "repro_torch.kernels.ssd.ops", "repro_torch.models.ssm"} <= set(_modules())
    assert PORT / "kernels" / "ssd" / "kernel.py" in SOURCES
    assert (PORT / "csrc" / "ssd.cu").exists()


def test_the_tuning_slice_is_covered():
    """The MLOS loop's modules, the RMSNorm kernel's and its CUDA source are
    among what the checks here walk."""
    assert {"repro_torch.core.stats", "repro_torch.core.agent", "repro_torch.core.campaign",
            "repro_torch.core.codegen", "repro_torch.core.smartcomponents",
            "repro_torch.core.optimizers.bayesopt", "repro_torch.launch.campaign",
            "repro_torch.launch.microbench", "repro_torch.launch.tuning",
            "repro_torch.kernels.rmsnorm.ref", "repro_torch.kernels.rmsnorm.kernel",
            "repro_torch.kernels.rmsnorm.ops"} <= set(_modules())
    assert (PORT / "csrc" / "rmsnorm.cu").exists()


def test_the_online_slice_is_covered():
    """The online tuner, the config facade, tracking, RPI, the trajectory
    and the serving benchmarks are among what the checks here walk."""
    assert {"repro_torch.runtime.online", "repro_torch.core.config",
            "repro_torch.core.tracking", "repro_torch.core.rpi", "repro_torch.core.baseline",
            "repro_torch.bench", "repro_torch.bench.serve_scenarios",
            "repro_torch.bench.online_tuning", "repro_torch.bench.runner",
            "repro_torch.bench.check"} <= set(_modules())
    for rel in ("runtime/online.py", "core/config.py", "core/tracking.py", "core/rpi.py",
                "core/baseline.py", "bench/__init__.py", "bench/serve_scenarios.py",
                "bench/online_tuning.py", "bench/runner.py", "bench/check.py"):
        assert PORT / rel in SOURCES


def test_the_captured_programs_slice_is_covered():
    """The step registry, the new benchmark twins and the server built on
    them are among what the checks here walk."""
    assert {"repro_torch.core.compilecache", "repro_torch.bench.kernel_autotune",
            "repro_torch.bench.configstore_roundtrip", "repro_torch.runtime.serve_loop",
            "repro_torch.kernels.build"} <= set(_modules())
    for rel in ("core/compilecache.py", "bench/kernel_autotune.py",
                "bench/configstore_roundtrip.py"):
        assert PORT / rel in SOURCES
    # no environment switch in the registry or the build cache
    for rel in ("core/compilecache.py", "kernels/build.py", "runtime/serve_loop.py"):
        assert "os.environ" not in (PORT / rel).read_text() and "getenv" not in (PORT / rel).read_text(), rel


def test_the_figures_examples_and_cold_warm_slice_is_covered():
    """The paper's figures, their suite, the cold/warm twin and the five
    examples are among what the checks here walk; the twin hands its
    children their kernel roots as arguments, never through the
    environment."""
    new = {"repro_torch.bench.fig3_hashtable", "repro_torch.bench.fig4_counters",
           "repro_torch.bench.fig5_spinlock", "repro_torch.bench.run",
           "repro_torch.bench.compile_cold_warm", "repro_torch.examples",
           "repro_torch.examples.quickstart", "repro_torch.examples.train_lm",
           "repro_torch.examples.serve_decode", "repro_torch.examples.autotune_kernels",
           "repro_torch.examples.campaign_quickstart"}
    assert new <= set(_modules())
    for name in new:
        rel = name.split(".", 1)[1].replace(".", "/")
        path = PORT / (f"{rel}/__init__.py" if (PORT / rel).is_dir() else f"{rel}.py")
        assert path in SOURCES, path
    text = (PORT / "bench" / "compile_cold_warm.py").read_text()
    assert "--build-root" in text and "environ[" not in text and "getenv" not in text
    import inspect

    from repro_torch.bench import compile_cold_warm, fig3_hashtable, fig5_spinlock, run

    for fn in (fig3_hashtable.run, fig5_spinlock.run, compile_cold_warm.run,
               compile_cold_warm.bench, run.suite):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__


def test_the_tensor_core_attention_is_covered():
    """The bf16 attention source and its wrapper are among what the checks
    here walk, and the wrapper names a library for each dtype it takes."""
    from repro_torch.kernels.flash_attention import kernel

    assert PORT / "kernels" / "flash_attention" / "kernel.py" in SOURCES
    for name in kernel.SOURCES.values():
        assert (PORT / "csrc" / f"{name}.cu").exists()
    assert (PORT / "csrc" / "flash_attention_tc.cu").read_text().count("wgmma.mma_async") >= 2


def test_the_tensor_core_ssd_is_covered():
    """The bf16 SSD source and its wrapper are among what the checks here
    walk, the wrapper names a library for each dtype it takes, and the
    bf16 one runs its products as mma.sync."""
    from repro_torch.kernels.ssd import kernel

    assert kernel.SOURCES == {torch.float32: "ssd", torch.bfloat16: "ssd_tc"}
    for name in kernel.SOURCES.values():
        assert (PORT / "csrc" / f"{name}.cu").exists()
    assert (PORT / "csrc" / "ssd_tc.cu").read_text().count("mma.sync.aligned.m16n8k16") == 1


def test_the_train_slice_is_covered():
    """The training path and the agent daemon are among what the checks
    here walk: schedules, AdamW, the tree helpers, the data pipeline, the
    checkpoint, fault, chaos, steps and train loop, the channel, telemetry,
    and the fault-tolerance twin."""
    assert {"repro_torch.tree", "repro_torch.optim.schedules", "repro_torch.optim.adamw",
            "repro_torch.data.pipeline", "repro_torch.runtime.checkpoint",
            "repro_torch.runtime.fault", "repro_torch.runtime.chaos", "repro_torch.runtime.steps",
            "repro_torch.runtime.train_loop", "repro_torch.core.channel",
            "repro_torch.core.telemetry", "repro_torch.bench.fault_tolerance"} <= set(_modules())


def test_the_gp_engine_slice_is_covered():
    """The torch GP engine and the three benchmark twins it runs in are
    among what the checks here walk."""
    assert {"repro_torch.core.optimizers.engine", "repro_torch.bench.optimizer_throughput",
            "repro_torch.bench.campaign_sweep", "repro_torch.bench.multi_instance"} <= set(
        _modules())
    for rel in ("core/optimizers/engine.py", "bench/optimizer_throughput.py",
                "bench/campaign_sweep.py", "bench/multi_instance.py"):
        assert PORT / rel in SOURCES


def test_the_moe_slice_is_covered():
    """The MoE layer and the model, step, tuning and benchmark modules that
    run it are among what the checks here walk; its component is tunable
    from the launch CLIs."""
    from repro_torch.launch import tuning
    from repro_torch.models import moe, transformer

    assert {"repro_torch.models.moe", "repro_torch.models.transformer",
            "repro_torch.models.model", "repro_torch.runtime.steps",
            "repro_torch.launch.tuning", "repro_torch.bench.serve_scenarios"} <= set(_modules())
    assert PORT / "models" / "moe.py" in SOURCES
    assert "moe" in transformer.FAMILIES
    assert tuning.SINGLETONS["torch_moe_dispatch"] is moe.moe_settings
    # no value read back to the host in the layer (tests/test_torch_moe.py runs it on fakes)
    tree = ast.parse((PORT / "models" / "moe.py").read_text())
    called = {node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)}
    assert not called & {"item", "tolist", "nonzero", "bincount", "one_hot",
                         "repeat_interleave", "unique", "masked_select"}


def test_the_spawned_agent_imports_no_torch():
    """The agent daemon's process (spawned) imports the module of its target
    and what that pulls in: none of it is torch (no CUDA in the side-car),
    jax or the reference."""
    code = ("import json, pickle, sys\n"
            "from repro_torch.core import agent\n"
            "pickle.loads(pickle.dumps(agent.agent_main))\n"
            "from repro_torch.core.optimizers import make_optimizer\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'repro'))\n"
            "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_kernels_add_by_no_atomics():
    """The train step is deterministic on the card: no source of a kernel it
    runs adds through atomics (whose order changes from run to run)."""
    for path in sorted((PORT / "csrc").glob("*.cu")):
        assert "atomic" not in path.read_text(), path.name


def test_training_refuses_a_missing_card(monkeypatch):
    """No CPU fallback: training and the fault twin on a CUDA device that
    is not there raise."""
    from repro_torch.bench import fault_tolerance
    from repro_torch.configs import get_config
    from repro_torch.runtime.train_loop import run_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(get_config("olmo-1b").reduced(), n_steps=1, global_batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fault_tolerance.run(quick=True)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_repro(path):
    roots = {name.split(".")[0] for name in _imported(ast.parse(path.read_text()))}
    assert not roots & set(FORBIDDEN), f"{path.name} imports {sorted(roots & set(FORBIDDEN))}"


def test_port_calls_no_library_attention():
    """Nor a library norm: RMSNorm is the port's own kernel."""
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        for banned in ("scaled_dot_product_attention", "torch.compile", "cpp_extension",
                       "rms_norm", "layer_norm"):
            assert banned not in text, f"{path.relative_to(ROOT)} uses {banned}"


def test_entry_points_default_to_cuda():
    """Every entry point runs on the card unless asked for the CPU, and the
    server's steps default to CUDA graphs there."""
    import inspect

    from repro_torch.bench import configstore_roundtrip, fault_tolerance, kernel_autotune
    from repro_torch.convert import train_state_from_reference
    from repro_torch.models import model
    from repro_torch.runtime import serve_loop, steps, train_loop
    from repro_torch.runtime.serve_loop import BatchedServer

    for fn in (model.init_params, model.init_cache, BatchedServer.__init__, kernel_autotune.run,
               kernel_autotune.bench, configstore_roundtrip.run, configstore_roundtrip.bench,
               steps.init_train_state, train_loop.run_training, fault_tolerance.run,
               fault_tolerance.bench, train_state_from_reference):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    assert inspect.signature(BatchedServer.__init__).parameters["step"].default is None
    assert serve_loop.resolve_step(None, torch.device("cuda")) == "graph"
    assert serve_loop.resolve_step(None, torch.device("cpu")) == "eager"
    for argv_main in (kernel_autotune.main, configstore_roundtrip.main, fault_tolerance.main):
        src = inspect.getsource(argv_main)
        assert 'ap.add_argument("--device", default="cuda"' in src
    # the GP engine and the twins that run it
    from repro_torch.bench import campaign_sweep, multi_instance, optimizer_throughput
    from repro_torch.core.optimizers import BayesOpt, optimizer_defaults
    from repro_torch.core.optimizers.engine import TorchGP

    for fn in (TorchGP.__init__, BayesOpt.__init__, optimizer_throughput.run,
               optimizer_throughput.bench, campaign_sweep.run, campaign_sweep.bench,
               multi_instance.run, multi_instance.bench):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    assert optimizer_defaults()["device"] == "cuda"
    for argv_main in (optimizer_throughput.main, campaign_sweep.main):
        assert 'ap.add_argument("--device", default="cuda"' in inspect.getsource(argv_main)


# ------------------------------------------------------------ chip_smoke.py
@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_without_a_card(chip_smoke, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_main_path_on_cpu(chip_smoke):
    """The serve phase's function at reduced size on the CPU: every request
    completes within its budget, ``_host_fetch`` runs once per interval,
    and (f32, CPU) the continuous streams equal the one-at-a-time ones."""
    from repro_torch.configs import get_config

    cfg = get_config("olmo-1b").reduced()
    out = chip_smoke.serve_main_path("cpu", cfg, capacity=64, max_batch=4, n_requests=8,
                                     max_width=32, long_max=16)
    m = out["metrics"]
    assert m["completed"] == 8 and out["prefill_calls"] == 8
    assert out["host_fetches"] == m["decode_syncs"] > 0
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}   # CPU: no kernel
    assert sorted(set(out["widths"])) == [2, 4, 8, 16, 32]
    assert out["identical_share"] == 1.0 and out["divergences"] == []


@pytest.mark.parametrize("name,widths", [("mamba2-780m", None), ("hymba-1.5b", [2, 8, 32])])
def test_chip_smoke_ssm_paths_on_cpu(chip_smoke, name, widths):
    """The serve-ssm and serve-hybrid phases' function at reduced size on the
    CPU, and the launches each family expects on the card."""
    from repro_torch.configs import get_config

    cfg = get_config(name).reduced()
    out = chip_smoke.serve_main_path("cpu", cfg, capacity=64, max_batch=4, n_requests=8,
                                     max_width=32, long_max=16, widths=widths)
    assert out["metrics"]["completed"] == 8 and out["prefill_calls"] == 8
    assert out["host_fetches"] == out["metrics"]["decode_syncs"] > 0
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}
    assert out["identical_share"] == 1.0
    hybrid = cfg.family == "hybrid"
    assert chip_smoke._expected_launches(cfg, 8) == {
        "flash_attention": 8 * cfg.n_layers if hybrid else 0, "ssd": 8 * cfg.n_layers,
        "rmsnorm": 0}


def test_chip_smoke_bound_counts_causal_work(chip_smoke):
    ms, by = chip_smoke.attention_bound_ms(1, 1024, 16, 16, 128, 2, chip_smoke.PEAK_BF16_FLOPS)
    bytes_ms = 1e3 * 2 * 128 * (2 * 1024 * 16 + 2 * 1024 * 16) / chip_smoke.PEAK_BYTES
    flops_ms = 1e3 * 4 * 128 * 16 * 1024 * 1025 / 2 / chip_smoke.PEAK_BF16_FLOPS
    assert ms == pytest.approx(max(bytes_ms, flops_ms)) and by == "bytes"


def test_chip_smoke_ssd_bound_counts_bytes_and_chunked_work(chip_smoke):
    """mamba2's widest prefill (bf16 B1 S1024 H48 P64 N128 G1): 14.9 MB
    moved, ~1.8 GFLOP of chunked work at chunk 64; bytes bound it."""
    ms, by = chip_smoke.ssd_bound_ms(1, 1024, 48, 64, 128, 1, 2, 64, chip_smoke.PEAK_BF16_FLOPS)
    moved = 2 * (2 * 1024 * 48 * 64 + 2 * 1024 * 128) + 4 * (1024 * 48 + 2 * 48) + 4 * 48 * 64 * 128
    assert moved == pytest.approx(14.9e6, rel=0.01)
    assert ms == pytest.approx(1e3 * moved / chip_smoke.PEAK_BYTES) and by == "bytes"
    pairs = 64 * 65 / 2    # C·Bᵀ once for the one group, the rest once per head
    flops = 16 * 2 * (pairs * 128 + 48 * (pairs * 64 + 2 * 64 * 128 * 64))
    ms_ops, by_ops = chip_smoke.ssd_bound_ms(1, 1024, 48, 64, 128, 1, 2, 64,
                                             flops / (2 * ms * 1e-3))
    assert by_ops == "operations" and ms_ops == pytest.approx(2 * ms)


def test_chip_smoke_rmsnorm_bound_counts_bytes(chip_smoke):
    """The kernels grid's r16384d1536 in bf16: 50.3 MB read and 50.3 MB
    written (75.5 MB read with the residual) bound it at 0.030 ms (0.045)."""
    for residual, reads, want in ((False, 1, 0.030), (True, 2, 0.045)):
        ms, by = chip_smoke.rmsnorm_bound_ms(16384, 1536, 2, 2, residual)
        moved = 2 * 16384 * 1536 * (reads + 1) + 2 * 1536
        assert ms == pytest.approx(1e3 * moved / chip_smoke.PEAK_BYTES) and by == "bytes"
        assert ms == pytest.approx(want, rel=0.01)


def test_chip_smoke_reads_ptxas_reports(chip_smoke):
    """The build phase's parser of an ``-Xptxas -v`` log: one row per entry
    function with its registers and spill stores."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z1fv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1fv",
        "    40 bytes stack frame, 52 bytes spill stores, 72 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 40 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1gv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers",
        "nvcc wall 9.5 s"])
    assert chip_smoke._ptxas_report(log) == [("_Z1fv", 168, 52), ("_Z1gv", 96, 0)]


def test_chip_smoke_times_every_attention_shape_it_names(chip_smoke):
    """OLMo-1B's and hymba-1.5b's widest prefill and the campaign grid's four
    attention workloads; SDPA's causal mask is the function at each."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import campaign

    shapes = chip_smoke.ATTN_TIMED
    assert shapes["olmo-1b prefill"] == (1, 1024, 16, 16, 128, 0)
    assert shapes["hymba-1.5b prefill"] == (1, 1024, 25, 5, 64, 2048)
    grid = {ops.workload_signature(b, s, s, d) for b, s, h, kh, d, _ in shapes.values()
            if h == campaign.ATTN_HEADS}
    assert set(campaign.GRIDS["kernels"]["torch_flash_attention"]) <= grid
    assert all(w == 0 or w >= s for _, s, _, _, _, w in shapes.values())


def test_chip_smoke_times_every_ssd_shape_it_names(chip_smoke):
    """mamba2-780m's and hymba-1.5b's widest prefill and the campaign grid's
    two SSD workloads (mamba2 heads)."""
    from repro_torch.kernels.ssd import ops
    from repro_torch.launch import campaign

    shapes = chip_smoke.SSD_TIMED
    assert shapes["mamba2-780m prefill"] == (1, 1024, 48, 64, 128, 1)
    assert shapes["hymba-1.5b prefill"] == (1, 1024, 25, 128, 16, 1)
    grid = {ops.workload_signature(b, s, h) for b, s, h, _, _, _ in shapes.values()}
    assert set(campaign.GRIDS["kernels"]["torch_ssd_kernel"]) <= grid


def test_chip_smoke_names_every_ssd_kernel(chip_smoke):
    """The profile sums every device kernel of both SSD sources, and the
    build phase's tensor-core check names the passes that compute a product."""
    from repro_torch.kernels.ssd import kernel

    sources = {name: (PORT / "csrc" / f"{name}.cu").read_text()
               for name in kernel.SOURCES.values()}
    kernels = {k for text in sources.values() for k in re.findall(r"\b(ssd\w*_kernel)\(", text)}
    assert kernels == set(chip_smoke.PORT_KERNELS["ssd"])
    assert set(chip_smoke.SSD_TC_PRODUCTS) < kernels
    assert all(k in sources["ssd_tc"] for k in chip_smoke.SSD_TC_PRODUCTS)
    assert chip_smoke.SSD_TC in chip_smoke.CUDA_SOURCES


def test_chip_smoke_online_paths_on_cpu(chip_smoke):
    """The online phase's functions at reduced size on the CPU: the tuner's
    journal is well formed, one fetch per sync, no kernel launched, a
    resumed tuner restores the champion and the budget; with the tuner in
    the loop the streams equal the one-at-a-time ones."""
    from repro_torch.configs import get_config

    cfg = get_config("olmo-1b").reduced()
    out = chip_smoke.online_main_path("cpu", cfg, capacity=64)
    kinds = [r["kind"] for r in out["rows"]]
    # the online benchmark's adapt phase: until a promotion or the budget is spent
    assert kinds[0] == "canary_start"
    assert out["promotions"] >= 1 or kinds.count("canary_verdict") == 3
    assert kinds.count("canary_verdict") <= 3
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}
    assert out["host_fetches"] > 0 and out["replays"] >= 1
    assert out["resolved"]["sync_interval"] == (out["champion"]["sync_interval"]
                                                if out["promotions"] else 4)
    par = chip_smoke.online_parity_path("cpu", cfg)
    assert par["divergences"] == [] and par["canaries"] >= 1
    with pytest.raises(AssertionError, match="malformed"):
        chip_smoke._check_journal([{**out["rows"][0], "seq": "1"}], out["rows"][0]["tuner"])


def test_chip_smoke_serve_bench_path_on_cpu(chip_smoke, tmp_path):
    out = chip_smoke.serve_bench_path("cpu", capacity=128, repeats=2,
                                      trajectory=tmp_path / "trajectory.jsonl")
    row = out["res"]["scenarios"]["heavy_tail"]
    assert len(row["continuous"]["tokens_per_s"]) == 2
    assert row["gang"]["total_tokens"] == row["continuous"]["total_tokens"]
    assert [r["metric"] for r in out["rows"]] == ["heavy_tail_tokens_per_s",
                                                  "heavy_tail_p99_latency_s"]
    # the warm-ups: 4 prompts at each of the mix's 5 width classes 2..32, as 5
    # gang batches and 20 continuous prefills; then 2 replays of 20 requests
    assert out["prefills"] == 5 + 20 + 2 * (20 + 5)
    assert out["timed_captures"] == {"gang": [0, 0], "continuous": [0, 0]}
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}


def test_chip_smoke_checks_every_attention_shape_its_serving_phases_run(chip_smoke, tmp_path,
                                                                       monkeypatch):
    """The kernels phase holds flash attention against its plain version at
    every prefill shape that the serving phases give it: the serving grid's
    (one measurement per cell: a cell's prompts come from its seed) and the
    float32 parity phase's reduced OLMo-1B shapes as they are, the serve
    benchmark's heavy tail (one replay per scheduler, reduced here) at
    OLMo-1B's published heads."""
    from repro_torch.bench import load_model
    from repro_torch.bench import serve_scenarios as twin
    from repro_torch.configs import get_config
    from repro_torch.core import configstore
    from repro_torch.core.registry import get_component
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import campaign as launch
    from repro_torch.runtime import traffic

    seen, real = [], ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                     kw["window"], kw["q_offset"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    checked = {case[:8] for case in chip_smoke.ATTN_CASES if case[8]}   # the causal ones
    old = configstore.set_default_store(configstore.ConfigStore(tmp_path / "store"))
    try:
        measure = launch.build_measure(device="cpu")
        for cell in launch.grid_cells("serving", budget=3, optimizer="bo", seed=0, device="cpu"):
            measure(cell, get_component(cell.component).space.defaults())
    finally:
        configstore.set_default_store(old)
    chip_smoke.online_parity_path("cpu", get_config("olmo-1b").reduced())
    assert seen and set(seen) <= checked, sorted(set(seen) - checked)
    seen.clear()
    params, cfg = load_model("olmo-1b", device="cpu", seed=7)
    arrivals = twin.scenario_arrivals(7, quick=False)["heavy_tail"]
    for mode in ("gang", "continuous"):
        traffic.replay(twin._server(params, cfg, mode, 128, "cpu"), arrivals)
    full = get_config("olmo-1b")
    widened = {(b, sq, sk, full.n_heads, full.n_kv_heads, full.hd, w, o)
               for b, sq, sk, _, _, _, w, o in seen}
    assert {b for b, *_ in seen} == {twin.MAX_BATCH, 1}       # gang and continuous prefills
    assert widened <= checked, sorted(widened - checked)
    # the examples phase (reduced configs on the card as here; quickstart trains
    # train_lm's smoke shape) and the cold/warm twin's child (its first train
    # step); a step count does not change a shape
    from repro_torch.bench import compile_cold_warm
    from repro_torch.examples import serve_decode, train_lm
    from repro_torch.kernels import build

    seen.clear()
    monkeypatch.setattr(build, "_root", build._root)     # the child sets the kernel root
    train_lm.main(["--device", "cpu", "--steps", "1", "--ckpt-dir", str(tmp_path / "lm")])
    serve_decode.main(["--device", "cpu"])
    compile_cold_warm.child_main(str(tmp_path / "root"), "cpu")
    assert {b for b, *_ in seen} == {8, 4, 1}       # train_lm / quickstart, the child, serving
    assert set(seen) <= checked, sorted(set(seen) - checked)


def test_chip_smoke_train_paths_on_cpu(chip_smoke, tmp_path):
    """The train phases' function at reduced size on the CPU: a first run
    checkpoints, a second resumes where it stopped, every loss is finite,
    no kernel launched; the MFU numerator and the launch factor the card
    is held to."""
    from repro_torch.configs import get_config

    cfg = get_config("olmo-1b").reduced()
    out = chip_smoke.train_main_path("cpu", cfg, batch=2, seq=32, steps=3, resume_to=4,
                                     ckpt_every=2, ckpt_dir=tmp_path)
    first, second = out["runs"]
    assert [r["step"] for r in first["rows"]] == [0, 1, 2]
    assert [r["step"] for r in second["rows"]] == [3]
    assert first["ckpt"]["saves"] == 2 and second["ckpt"]["saves"] == 1
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}
    assert chip_smoke._remat_factor(get_config("olmo-1b"), 8, 2048) == 2
    full = get_config("olmo-1b")
    want = 6.0 * full.param_count() * 8 * 2048 + 12.0 * 16 * 8 * 2048 * 2048 * 16 * 128 / 2
    assert chip_smoke.train_flops(full, 8, 2048) == pytest.approx(want)
    assert chip_smoke.train_flops(get_config("mamba2-780m"), 4, 1024) == pytest.approx(
        6.0 * get_config("mamba2-780m").param_count() * 4 * 1024)
    assert chip_smoke.TRAIN_GRAD_SHAPES["olmo-1b attention"] == (8, 2048, 2048, full.n_heads,
                                                                 full.n_kv_heads, full.hd, 0, 0,
                                                                 True)
    m2 = get_config("mamba2-780m")
    assert chip_smoke.TRAIN_GRAD_SHAPES["mamba2-780m ssd"] == (4, 1024, m2.ssm_heads,
                                                               m2.ssm_head_dim, m2.ssm_state,
                                                               m2.ssm_groups)


def test_chip_smoke_step_grad_path_on_cpu(chip_smoke):
    """The whole-step gradient check at reduced size on the CPU (where the
    kernel's path is the plain one): every dtype and depth reported, finite
    norms, the worst leaf named; float32 agrees exactly, bf16 is held to
    the float32 gradient."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), dtype="bfloat16").validate()
    out = chip_smoke.phase_train_step_grad("cpu", "cpu", cfg, batch=2, seq=32, depths=(1,))
    assert set(out) == {f"{d} {n} layers" for d in ("bfloat16", "float32")
                        for n in (1, cfg.n_layers)}
    for key, row in out.items():
        assert math.isfinite(row["grad_norm"]) and row["grad_norm"] > 0 and row["worst_leaf"]
        if key.startswith("float32"):                 # the same plain path twice
            assert row["grad_norm_rel"] == 0.0 and row["worst_leaf_rel"] == 0.0
        else:                                         # bf16 against the float32 gradient
            assert row["against"] == "the float32 plain path"
            assert 0 < row["worst_leaf_rel"] <= row["tol"][1]


@pytest.mark.slow
def test_chip_smoke_agent_path_on_cpu(chip_smoke):
    """The agent phase's function at reduced size on the CPU: a spawned
    daemon tunes ``lr_scale`` of a live run, every update lands on its
    steps, the report arrives and the daemon exits."""
    from repro_torch.configs import get_config

    out = chip_smoke.agent_main_path("cpu", get_config("olmo-1b").reduced(), batch=2, seq=32)
    assert len(out["applied"]) == 5 and out["report"]["evaluations"] == 4
    assert len(out["history"]) == 10 and out["launches"]["flash_attention"] == 0


def test_chip_smoke_optimizer_path_on_cpu(chip_smoke, tmp_path, monkeypatch):
    """The optimizer phase's helpers at quick size on the CPU: the
    throughput twin, parity of the engine (here CPU against CPU) with the
    numpy backend, the batched ask, the sweep with both backends, and the
    ``kernels`` grid with ``optimizer.backend=torch`` (every cell done and
    promoted, the defaults restored).  The grid's kernel timings are
    replaced by a planted cost of the settings: on a shared CPU a timed
    best can read slower than the default on re-measurement, and the gate
    then rightly refuses it.  The daemon's half is
    ``tests/test_torch_channel_agent.py::test_a_torch_backed_daemon_matches_the_in_process_drive``."""
    from torch_threads import one_thread

    from repro_torch.core.optimizers import optimizer_defaults
    from repro_torch.launch import campaign as tlaunch

    monkeypatch.setattr(tlaunch, "_time_us", lambda cell, fn, args, settings, reps: {
        "time_us": float(sum(len(str(v)) for v in settings.values()))})
    before = optimizer_defaults()
    with one_thread():
        out = chip_smoke.optimizer_main_path("cpu", quick=True)
        sweep = chip_smoke.optimizer_sweep_path("cpu", quick=True, out_dir=tmp_path)
        grid = chip_smoke.optimizer_grid_path("cpu", budget=4, quick=True)
    assert out["parity_asks"] == len(chip_smoke.OPT_PARITY_SEEDS) * chip_smoke.OPT_PARITY_ASKS
    assert out["variants"] == {"asks": 6, "max_abs_err": 0.0}   # 2 kernels x 3 acquisitions
    assert out["theta"]["rel"] == 0.0                 # the same device twice
    assert out["steps"]["gp.suggest"]["runs"] > 0 and out["steps"]["gp.suggest"]["captures"] == 0
    assert set(sweep) == {"numpy", "torch"}
    assert len(grid["results"]) == 6 and all(r.promoted for r in grid["results"].values())
    assert grid["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}   # CPU: no kernel
    assert optimizer_defaults() == before


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mixtral-8x22b"])
def test_chip_smoke_moe_serve_paths_on_cpu(chip_smoke, name):
    """The serve-moe and serve-moe-window phases' function at reduced size
    on the CPU, and the launches the MoE family expects on the card: one
    flash attention a layer per prefill."""
    from repro_torch.configs import get_config

    cfg = get_config(name).reduced()
    out = chip_smoke.serve_main_path("cpu", cfg, capacity=64, max_batch=4, n_requests=8,
                                     max_width=32, long_max=16)
    assert out["metrics"]["completed"] == 8 and out["prefill_calls"] == 8
    assert out["host_fetches"] == out["metrics"]["decode_syncs"] > 0
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}
    assert chip_smoke._expected_launches(cfg, 8) == {
        "flash_attention": 8 * cfg.n_layers, "ssd": 0, "rmsnorm": 0}


def test_chip_smoke_checks_every_moe_prefill_shape(chip_smoke):
    """The kernels phase holds flash attention against its plain version at
    every prefill shape of the MoE phases: OLMoE-1B-7B's are OLMo-1B's
    (H16 K16 D128, every pow2 width to 1024), Mixtral-8x22B's at every
    width the serve-moe-window phase asks for, and reduced Mixtral's; the
    phase's capacity lets its widest prompt prefill past the window."""
    from repro_torch.configs import get_config

    olmoe, mixtral = get_config("olmoe-1b-7b"), get_config("mixtral-8x22b")
    checked = {case[:8] for case in chip_smoke.ATTN_CASES if case[8]}   # the causal ones
    for w in (2 ** k for k in range(1, 11)):
        assert (1, w, w, olmoe.n_heads, olmoe.n_kv_heads, olmoe.hd, 0, 0) in checked
        assert (1, w, w, 4, 2, 16, 0, 0) in checked or w > 32
    for w in chip_smoke.MOE_WINDOW_WIDTHS:
        assert (1, w, w, mixtral.n_heads, mixtral.n_kv_heads, mixtral.hd, mixtral.window,
                0) in checked
    small = mixtral.reduced()
    for w in (2, 4, 8, 16, 32):
        assert (1, w, w, small.n_heads, small.n_kv_heads, small.hd, small.window, 0) in checked
    from repro_torch.runtime.serve_loop import BatchedServer

    widest = max(chip_smoke.MOE_WINDOW_WIDTHS)
    assert widest > mixtral.window
    server = types.SimpleNamespace(capacity=chip_smoke.MOE_WINDOW_CAPACITY)
    assert BatchedServer._width_of(server, widest) == widest


def test_chip_smoke_moe_dispatch_and_train_paths_on_cpu(chip_smoke, tmp_path):
    """The moe-dispatch and train-moe phases' functions at reduced size on
    the CPU: every strategy's row with its bound, drops only at the lower
    capacity factors, the capacity path against the dense oracle; two train
    runs of the same bits; the reduced checkpoint run resumes."""
    from repro_torch.configs import get_config

    cfg = get_config("olmoe-1b-7b").reduced()
    rows = chip_smoke.moe_dispatch_path("cpu", cfg, shapes={"decode": (8, 1),
                                                            "prefill": (1, 64)})
    for row in rows.values():
        assert set(row["strategies"]) == {"auto", "local_tp", "gather", "dense"}
        d = row["dropped_frac"]
        assert d[1.0] >= d[1.25] >= d[2.0] >= 0.0
        assert all(r["bound_ms"] > 0 and "ms" not in r for r in row["strategies"].values())
    assert rows["prefill"]["strategies"]["dense"]["assignments"] == 64 * cfg.moe_top_k
    out = chip_smoke.train_twice_path("cpu", cfg, batch=2, seq=16, steps=2, label="train-moe")
    assert [r["step"] for r in out["runs"][1]["rows"]] == [0, 1]
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}
    resumed = chip_smoke.train_main_path("cpu", cfg, batch=4, seq=64, steps=2, resume_to=3,
                                         ckpt_every=1, ckpt_dir=tmp_path)
    assert [[r["step"] for r in run["rows"]] for run in resumed["runs"]] == [[0, 1], [2]]
    full = get_config("olmoe-1b-7b")
    want = 6.0 * full.active_param_count() * 4 * 2048 + 12.0 * 16 * 4 * 2048 * 2048 * 16 * 128 / 2
    assert chip_smoke.train_flops(full, 4, 2048) == pytest.approx(want)


def test_chip_smoke_moe_bound_counts_touched_experts(chip_smoke):
    """OLMoE's decode step at T 8: all 64 experts touched, 64 assignments;
    reading the experts' weights (805 MB) bounds it at ~0.24 ms a layer."""
    ms, by = chip_smoke.moe_bound_ms(8, 2048, 1024, 64, 64, 64, 2, chip_smoke.PEAK_BF16_FLOPS)
    moved = 2 * (2 * 8 * 2048 + 2048 * 64 + 3 * 64 * 2048 * 1024)
    assert moved == pytest.approx(805e6, rel=0.01)
    assert ms == pytest.approx(1e3 * moved / chip_smoke.PEAK_BYTES) and by == "bytes"
    ms, by = chip_smoke.moe_bound_ms(8192, 2048, 1024, 64, 64, 8192 * 8, 2,
                                     chip_smoke.PEAK_BF16_FLOPS)
    assert by == "operations" and ms == pytest.approx(
        1e3 * (2.0 * 8192 * 2048 * 64 + 6.0 * 8192 * 8 * 2048 * 1024) / chip_smoke.PEAK_BF16_FLOPS)
