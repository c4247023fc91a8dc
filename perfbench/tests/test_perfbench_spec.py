"""BENCHMARK.json against the contract it is written to: names, units and
keys; every file the harness finds by name exists."""
import re

import pytest

from perfbench.lib.spec import ROOT, Spec, load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
B = load_json(ROOT / "BENCHMARK.json")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(B["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in B["paths"])
    assert len(B["command"]) <= 32 and all(line(w) for w in B["command"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51


def test_names_units_and_keys():
    names = []
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).exists()
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = [w["name"] for w in B["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in B["workloads"]}) == len(cells)
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and line(w["why"])
    metrics = B["end_to_end"] + B["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"])
    assert "setup_s" in {m["name"] for m in B["end_to_end"]}
    assert len(str(B).encode()) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_every_cell_finds_its_files_and_reports_enough(cell):
    s = Spec(cell)
    e2e = {m["name"] for m in s.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2 and s.per_layer()
    for m in s.end_to_end() + s.per_layer():
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    for m in s.per_layer():
        assert m["moves"] in e2e
    assert (ROOT / "perfbench" / "kinds" / f"{s.cell['kind']}.py").exists()
    assert s.cell["check"]["limits"]


def test_layers_named_alike():
    by_layer = {}
    for m in B["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
