"""The cold/warm twin's plumbing on the CPU (``repro_torch.bench.compile_cold_warm``):
a child builds into the root it is given and nowhere else, the priming
child is not counted, the temporary roots go, and
``check_compile_cold_warm`` holds a record to the reference's assertions
less the ``xla_runtime`` block.  On the CPU nothing is built, so the
verdict itself is the card's to judge.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from repro_torch.bench import check, compile_cold_warm, runner
from repro_torch.core import compilecache
from repro_torch.kernels import build
from torch_threads import one_thread_here_and_in_children


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Reduced models on a CPU shared with the other test workers: one
    intra-op thread here and in the interpreters the tests start."""
    with one_thread_here_and_in_children():
        yield


@pytest.fixture
def restore_root(monkeypatch):
    """The child sets the process's kernel root: put it back afterwards."""
    monkeypatch.setattr(build, "_root", build._root)


def test_build_dir_follows_the_root_it_is_given(restore_root, tmp_path):
    default = build.build_dir()
    assert default == compilecache.persistent_cache_dir(build.BUILD_ROOT)
    assert build.set_root(tmp_path) == build.BUILD_ROOT
    assert build.build_dir() == compilecache.persistent_cache_dir(tmp_path)
    assert build.set_root(build.BUILD_ROOT) == tmp_path and build.build_dir() == default


@pytest.fixture
def fresh_registry(monkeypatch):
    """An empty step registry for the test, so the child's step lookup is
    a miss whatever ran before in this process; the old one comes back."""
    monkeypatch.setattr(compilecache, "_REGISTRY", {})


def test_the_child_honours_its_build_root(restore_root, fresh_registry, tmp_path):
    out = compile_cold_warm.child_main(str(tmp_path / "root"), "cpu")
    assert Path(out["build_dir"]) == compilecache.persistent_cache_dir(tmp_path / "root")
    assert out["first_step_s"] > 0 and out["counters"]["misses"] >= 1
    assert out["libraries"] == [] and out["launches"] == 0     # a CPU tensor builds nothing
    assert out["device"] == "cpu"


def test_the_child_counts_only_its_own_step(restore_root, fresh_registry, monkeypatch,
                                            tmp_path):
    """Launches and registry counts that an earlier caller left in the
    process-wide counters are not the child's."""
    from repro_torch.kernels.flash_attention import kernel as attn_kernel

    monkeypatch.setattr(attn_kernel.flash_attention, "launches",
                        attn_kernel.flash_attention.launches + 14)
    monkeypatch.setitem(compilecache._COUNTERS, "misses", compilecache._COUNTERS["misses"] + 5)
    out = compile_cold_warm.child_main(str(tmp_path / "root"), "cpu")
    assert out["launches"] == 0 and out["counters"]["misses"] == 1
    assert out["counters"]["hits"] == 0


def test_the_priming_child_is_not_counted_and_the_roots_go(monkeypatch):
    plans = []

    def fake_children(plan, device):
        plans.append(list(plan))
        for root in plan:
            assert root.parent.exists()
        return [{"first_step_s": float(i + 1), "counters": {"misses": 1}, "libraries": [],
                 "build_dir": str(root), "launches": 0} for i, root in enumerate(plan)]

    monkeypatch.setattr(compile_cold_warm, "_children", fake_children)
    res = compile_cold_warm.run(reps=3, device="cpu")
    (plan,) = plans
    cold, warm = plan[:3], plan[3:]
    assert len(set(cold)) == 3 and len(set(warm)) == 1 and not set(cold) & set(warm)
    assert len(warm) == 4                                   # the priming child, then 3
    assert res["cold_s"] == [1.0, 2.0, 3.0] and res["priming_s"] == 4.0
    assert res["warm_s"] == [5.0, 6.0, 7.0]
    assert res["roots_removed"] and not plan[0].parent.exists()


def _record(**over):
    d = {"quick": True, "cold_s": [12.0, 11.5, 12.4, 11.9, 12.2, 12.1],
         "warm_s": [0.9, 0.8, 1.0, 0.85, 0.95, 0.9],
         "verdict": {"verdict": "improved", "candidate_location": 0.9,
                     "baseline_location": 12.05},
         "counters": {"hits": 0, "misses": 1}}
    d.update(over)
    return d


def _write(tmp_path, d):
    (tmp_path / "compile_cold_warm.json").write_text(json.dumps(d))


def test_check_accepts_a_good_record(tmp_path):
    _write(tmp_path, _record())
    check.check_compile_cold_warm(expect_quick=True, bench_dir=tmp_path)


@pytest.mark.parametrize("bad", [
    dict(cold_s=[12.0, 11.5, 12.4, 11.9, 12.2]),                       # 5 samples
    dict(verdict={"verdict": "noise", "candidate_location": 0.9, "baseline_location": 12.0}),
    dict(counters={"hits": 1, "misses": 0}),
    dict(warm_s=[0.9, 0.8, 1.0, 0.85, 0.95, 0.0]),
], ids=["five-samples", "noise", "no-miss", "zero-sample"])
def test_check_rejects(tmp_path, bad):
    _write(tmp_path, _record(**bad))
    with pytest.raises(AssertionError):
        check.check_compile_cold_warm(expect_quick=True, bench_dir=tmp_path)


def test_the_twin_is_registered_with_its_check():
    assert "compile_cold_warm" in runner.REGISTRY
    assert check.CHECKS["compile_cold_warm"] is check.check_compile_cold_warm


def test_the_twin_refuses_a_missing_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_cold_warm.run(reps=1)


@pytest.mark.slow
def test_fresh_children_build_into_their_own_roots():
    """Three real interpreters (cold, priming, warm): each reports the root
    it was given, every cold root is its own, and all are removed."""
    res = compile_cold_warm.run(reps=1, device="cpu")
    assert len(res["cold_s"]) == 1 and len(res["warm_s"]) == 1
    cold_dir, warm_dir = Path(res["cold_build_dirs"][0]), Path(res["warm_build_dir"])
    assert cold_dir != warm_dir and cold_dir.parents[1].name == "cold0"
    assert warm_dir.parents[1].name == "warm"
    assert res["roots_removed"] and not cold_dir.exists()
    assert res["counters"]["misses"] >= 1
