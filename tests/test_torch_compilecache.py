"""The port's step registry (``repro_torch.core.compilecache``) and the
namespace of its built-kernel cache, against the reference's registry
contracts (tests/test_compilecache.py) where they have a torch meaning.

``Graphs`` with ``capture=True`` needs a card.  Here it runs on a stand-in
graph (:class:`FakeGraph`), so the registry's own logic is held on the CPU:
warm-up then capture on the first call, replays after it, the launch
counters recorded at capture and added at each replay, a binding that never
moves to other buffers, and no eager fallback when a capture or replay
fails.  A replay of the stand-in runs nothing; a run that must compute
replays the captured body instead (``replays_body``).  The card's own
graphs are held in tests/test_torch_kernel_card.py.
"""
from __future__ import annotations

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import compilecache as jcompilecache
from repro_torch.configs import get_config
from repro_torch.core import compilecache, configstore
from repro_torch.core.compilecache import (Graphs, cache_counters, cached_step, clear_registry,
                                           config_signature, step_counts)
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.ssd import kernel as ssd_kernel


@pytest.fixture
def registry():
    clear_registry()
    yield
    clear_registry()


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: records the body it captured;
    a replay runs it only if ``replays_body``."""

    replays_body = False

    def __init__(self, fn, args):
        self.fn, self.args, self.replays = fn, args, 0

    def replay(self):
        self.replays += 1
        if self.replays_body:
            self.fn(*self.args)


@pytest.fixture
def fake_capture(monkeypatch, registry):
    """The capture path on the CPU: the warm-up and the capture run the
    body (a real capture runs nothing, so a test body must be safe to run
    twice), a replay runs the stand-in's replay."""
    calls = {"warm_up": 0, "capture": 0}

    def warm_up(fn, args):
        calls["warm_up"] += 1
        fn(*args)

    def capture(fn, args, pool):
        calls["capture"] += 1
        fn(*args)
        return FakeGraph(fn, args)

    monkeypatch.setattr(compilecache, "_warm_up", warm_up)
    monkeypatch.setattr(compilecache, "_capture", capture)
    monkeypatch.setattr(compilecache, "_new_pool", lambda: ("pool",))
    monkeypatch.setattr(FakeGraph, "replays_body", False)
    return calls


# --------------------------------------------------------------- the registry
def test_cached_step_memoizes_by_key_and_context(registry):
    f = cached_step(lambda x: x + 1, key="t.step", context=("cfg-a",))
    g = cached_step(lambda x: x + 2, key="t.step", context=("cfg-a",))
    h = cached_step(lambda x: x + 1, key="t.step", context=("cfg-b",))
    assert f is g and f is not h
    c = cache_counters()
    assert c["hits"] == 1 and c["misses"] == 2 and c["entries"] == 2.0


def test_cached_step_no_rebuild_across_reconstruction(registry):
    """Rebuilding 'the same step' (a fresh function, same context) returns the
    first build: its body is the one that runs."""
    ran = []

    def make(tag):
        def step(x):
            ran.append(tag)
            return x * 2
        return step

    x = torch.ones(4)
    f = cached_step(make("first"), key="t.rebuild", context=("cfg",))
    torch.testing.assert_close(f(x), 2 * x)
    g = cached_step(make("second"), key="t.rebuild", context=("cfg",))
    torch.testing.assert_close(g(x), 2 * x)
    assert ran == ["first", "first"]
    assert cache_counters()["build_seconds"] > 0


def test_clear_registry_drops_steps_and_zeroes_counters(registry):
    cached_step(lambda x: x, key="t.clear")
    clear_registry()
    assert cache_counters() == {"hits": 0, "misses": 0, "build_seconds": 0.0, "captures": 0,
                                "replays": 0, "entries": 0.0}
    assert step_counts() == {}


@pytest.mark.parametrize("name", ["olmo-1b", "mamba2-780m", "hymba-1.5b", "olmoe-1b-7b"])
def test_config_signature_is_the_references(name):
    """The same function as the reference's: equal configs give equal
    signatures, in both packages, at full and reduced size."""
    for cfg, jcfg in ((get_config(name), jget_config(name)),
                      (get_config(name).reduced(), jget_config(name).reduced())):
        assert config_signature(cfg) == jcompilecache.config_signature(jcfg)
    assert config_signature(get_config(name)) == config_signature(get_config(name))
    assert config_signature(get_config(name)) != config_signature(get_config(name).reduced())


def test_config_signature_of_non_dataclasses():
    assert config_signature((1, "a")) == jcompilecache.config_signature((1, "a"))
    assert config_signature(3).startswith("int:")


# ------------------------------------------------------- the built-kernel cache
def test_build_dir_is_namespaced_as_the_references_cache_dir():
    hw, sw = configstore.hardware_fingerprint(), configstore.sw_fingerprint()
    want = build.BUILD_ROOT / jcompilecache._sanitize(hw) / jcompilecache._sanitize(sw)
    assert build.build_dir() == want == compilecache.persistent_cache_dir(build.BUILD_ROOT)
    assert build.BUILD_ROOT.parts[-2:] == ("build", "kernels")
    for s in ("cuda:NVIDIA H100 80GB HBM3:x1", "torch-2.11.0+cu128/cuda-12.8/py-3.12", "::"):
        assert compilecache._sanitize(s) == jcompilecache._sanitize(s)


def test_library_hash_covers_source_flags_and_nvcc(monkeypatch):
    monkeypatch.setattr(build, "nvcc_version", lambda: "Cuda compilation tools, release 12.8")
    a = build.library_path("rmsnorm")
    assert a.parent == build.build_dir() and a.name.startswith("rmsnorm-") and a.suffix == ".so"
    assert build.library_path("rmsnorm") == a
    monkeypatch.setattr(build, "nvcc_version", lambda: "Cuda compilation tools, release 12.9")
    assert build.library_path("rmsnorm") != a
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("rmsnorm").name not in (a.name,)


def test_library_hash_moves_with_the_hardware(monkeypatch):
    monkeypatch.setattr(build, "nvcc_version", lambda: "nvcc")
    a = build.library_path("ssd")
    monkeypatch.setattr(compilecache, "hardware_fingerprint", lambda: "cuda:Other_card:x1")
    b = build.library_path("ssd")
    assert a.name == b.name and a.parent != b.parent and b.parent.parent.name == "cuda-Other_card-x1"


# ------------------------------------------------------- steps on static buffers
def _adder(out, x):
    out.add_(x)


def test_eager_bound_step_runs_its_body_on_its_buffers(registry):
    g = Graphs(capture=False)
    out, x = torch.zeros(3), torch.ones(3)
    step = g.bind("t.add", _adder, out, x)
    step()
    step()
    torch.testing.assert_close(out, 2 * x)
    assert g.bind("t.add", _adder, out, x) is step          # same buffers: the same step
    assert step_counts()["t.add"] == {"runs": 2, "captures": 0, "replays": 0}
    assert g.captures == {} and g.replays == {}


def test_a_bound_step_never_moves_to_other_buffers(registry):
    g = Graphs(capture=False)
    out = torch.zeros(3)
    g.bind("t.add", _adder, out, torch.ones(3))
    with pytest.raises(ValueError, match="other buffers"):
        g.bind("t.add", _adder, torch.zeros(3), torch.ones(3))
    other = g.bind("t.add", _adder, torch.zeros(5), torch.ones(5))   # another shape class
    assert len(g.bound) == 2 and other.args[0].shape == (5,)


def _doubler(out, x):
    out.add_(2 * x)


def test_variants_of_one_key_are_programs_of_their_own(fake_capture):
    """Two programs that one key and one shape class cannot tell apart (a
    constant of the program differs) bind apart by ``variant``, on other
    buffers or on the same ones, each capturing its own graph; the counts
    stay per key."""
    g = Graphs(capture=True)
    out, x = torch.zeros(3), torch.ones(3)
    add = g.bind("t.op", _adder, out, x, variant="add")
    double = g.bind("t.op", _doubler, out, x, variant="double")     # the same buffers
    assert add is not double and g.bind("t.op", _adder, out, x, variant="add") is add
    with pytest.raises(ValueError, match="other buffers"):
        g.bind("t.op", _doubler, torch.zeros(3), x, variant="double")
    add()
    double()
    assert g.captures == {"t.op": 2}
    assert add.graph is not double.graph
    assert step_counts()["t.op"] == {"runs": 2, "captures": 2, "replays": 0}


def test_graph_step_warms_up_captures_once_then_replays(fake_capture):
    g = Graphs(capture=True)
    out, x = torch.zeros(3), torch.ones(3)
    step = g.bind("t.add", _adder, out, x)
    step()                                                  # warm-up (real) + capture
    torch.testing.assert_close(out, 2 * x)                  # the stand-in capture ran it too
    assert fake_capture == {"warm_up": 1, "capture": 1}
    for _ in range(3):
        step()
    assert step.graph.replays == 3 and fake_capture == {"warm_up": 1, "capture": 1}
    assert g.captures == {"t.add": 1} and g.replays == {"t.add": 3}
    assert step_counts()["t.add"] == {"runs": 4, "captures": 1, "replays": 3}
    c = cache_counters()
    assert c["captures"] == 1 and c["replays"] == 3 and c["build_seconds"] > 0


def test_replays_add_the_launches_recorded_at_capture(fake_capture, monkeypatch):
    """A replay runs no Python, so the wrappers' counters would not move: the
    increase during the capture is added at every replay, and the warm-up
    counts as the real execution it is.  The counters are process-wide, so
    the test puts them back."""
    monkeypatch.setattr(fa_kernel.flash_attention, "launches", fa_kernel.flash_attention.launches)
    monkeypatch.setattr(ssd_kernel.ssd, "launches", ssd_kernel.ssd.launches)
    def body(out):
        fa_kernel.flash_attention.launches += 2            # as two wrapper calls would
        ssd_kernel.ssd.launches += 1
        out.add_(1)

    fa0, ssd0 = fa_kernel.flash_attention.launches, ssd_kernel.ssd.launches
    step = Graphs(capture=True).bind("t.kernels", body, torch.zeros(1))
    step()
    assert (fa_kernel.flash_attention.launches - fa0, ssd_kernel.ssd.launches - ssd0) == (4, 2)
    assert step.deltas == (2, 1, 0)                         # flash attention, SSD, RMSNorm
    for _ in range(5):
        step()
    assert (fa_kernel.flash_attention.launches - fa0, ssd_kernel.ssd.launches - ssd0) == (14, 7)


def test_a_failed_capture_raises_and_never_falls_back(monkeypatch, fake_capture):
    def broken(fn, args, pool):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(compilecache, "_capture", broken)
    out = torch.zeros(1)
    step = Graphs(capture=True).bind("t.broken", _adder, out, torch.ones(1))
    with pytest.raises(RuntimeError, match="capture failed"):
        step()
    assert float(out) == 1.0                                # the warm-up ran, once
    with pytest.raises(RuntimeError, match="never falls back"):
        step()
    assert float(out) == 1.0 and fake_capture["warm_up"] == 1


def test_a_failed_replay_raises(fake_capture, monkeypatch):
    step = Graphs(capture=True).bind("t.replay", _adder, torch.zeros(1), torch.ones(1))
    step()

    def fail():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(step.graph, "replay", fail)
    with pytest.raises(RuntimeError, match="illegal"):
        step()
    with pytest.raises(RuntimeError, match="never falls back"):
        step()


def test_settings_resolve_at_capture(fake_capture, tmp_path):
    """A graph holds the tiles its kernels resolved when it was captured: a
    later override (or promotion) reaches only graphs captured after it, as
    the reference's ``cached_jit`` holds no store generation."""
    wl = attn_ops.workload_signature(1, 64, 64, 64)
    seen = []

    def body(out):
        seen.append(attn_ops.attention_settings.settings_for(wl)["block_q"])
        out.add_(1)

    store = configstore.ConfigStore(tmp_path / "store")
    old = configstore.set_default_store(store)
    try:
        first = Graphs(capture=True).bind("t.settings", body, torch.zeros(1))
        first()
        store.set_override("torch_flash_attention", wl, {"block_q": 128})
        first()
        first()
        assert seen == [64, 64]                             # warm-up and capture, then replays
        Graphs(capture=True).bind("t.settings", body, torch.zeros(1))()
        assert seen == [64, 64, 128, 128]                   # a new owner's capture sees it
        eager = Graphs(capture=False).bind("t.settings", body, torch.zeros(1))
        store.clear_override("torch_flash_attention", wl)
        eager()
        assert seen[-1] == 64                               # eager resolves at every call
    finally:
        configstore.set_default_store(old)


def test_an_owner_is_freed_without_the_cycle_collector(fake_capture):
    """A server's graphs and buffers go when the server goes, by reference
    counting: left to the cycle collector, a graph's destructor could run
    inside another graph's capture and invalidate it."""
    import gc
    import weakref

    collecting = gc.isenabled()
    gc.disable()
    try:
        g = Graphs(capture=True)
        out = torch.zeros(2)
        step = g.bind("t.free", _adder, out, torch.ones(2))
        step()
        step()
        refs = [weakref.ref(x) for x in (g, step, out)]
        del g, step, out
        assert [r() for r in refs] == [None, None, None]
    finally:
        if collecting:
            gc.enable()


def test_captures_run_with_the_cycle_collector_paused(monkeypatch, fake_capture):
    import gc

    seen = []

    def capture(fn, args, pool):
        seen.append(gc.isenabled())
        return FakeGraph(fn, args)

    monkeypatch.setattr(compilecache, "_capture", capture)
    enabled = gc.isenabled()
    Graphs(capture=True).bind("t.gc", _adder, torch.zeros(1), torch.ones(1))()
    assert seen == [False] and gc.isenabled() == enabled
