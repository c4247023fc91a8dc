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
    assert len(_modules()) >= 25


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_repro(path):
    roots = {name.split(".")[0] for name in _imported(ast.parse(path.read_text()))}
    assert not roots & set(FORBIDDEN), f"{path.name} imports {sorted(roots & set(FORBIDDEN))}"


def test_port_calls_no_library_attention():
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        for banned in ("scaled_dot_product_attention", "torch.compile", "cpp_extension"):
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
    assert out["launches"] == 0          # a CPU tensor never reaches the kernel
    assert sorted(set(out["widths"])) == [2, 4, 8, 16, 32]
    assert out["identical_share"] == 1.0 and out["divergences"] == []


def test_chip_smoke_bound_counts_causal_work(chip_smoke):
    ms, by = chip_smoke.attention_bound_ms(1, 1024, 16, 16, 128, 2, chip_smoke.PEAK_BF16_FLOPS)
    bytes_ms = 1e3 * 2 * 128 * (2 * 1024 * 16 + 2 * 1024 * 16) / chip_smoke.PEAK_BYTES
    flops_ms = 1e3 * 4 * 128 * 16 * 1024 * 1025 / 2 / chip_smoke.PEAK_BF16_FLOPS
    assert ms == pytest.approx(max(bytes_ms, flops_ms)) and by == "bytes"
