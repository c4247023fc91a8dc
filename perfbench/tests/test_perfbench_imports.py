"""Nothing under perfbench/ imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the port."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def imported(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in imported(path)
    src = path.read_text()
    assert "..lib" not in src and "..kinds" not in src


def test_the_check_catches_a_jax_import():
    tree = "import jax.numpy\nfrom repro.models import x\nimport repro_torch\n"
    names = set()
    for node in ast.walk(ast.parse(tree)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names & {"jax", "repro"} == {"jax", "repro"} and "repro_torch" in names


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from perfbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "olmo-1b.chat-backlog", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    from perfbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType("repro_torch_fake"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("repro.fake"))
    assert run.forbidden_modules() == ["repro.fake"]
