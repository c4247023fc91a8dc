"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
jax and nothing of the reference package ``repro``, never import triton
(the port's kernel is CUDA C++), and never call a library attention.  The
chip smoke script's main-path phase runs here on the CPU at reduced size,
so its control flow is rehearsed before it reaches the card.
"""
import ast
import importlib.util
import json
import os
import pkgutil
import re
import subprocess
import sys
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
    assert len(_modules()) >= 29


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
    import inspect

    from repro_torch.models import model
    from repro_torch.runtime.serve_loop import BatchedServer

    for fn in (model.init_params, model.init_cache, BatchedServer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__


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
