"""The port's config-resolution facade (``repro_torch.core.config``), the
registry's module-level ``settings_for(context)`` and ``default_instance``,
and the session factory, against the reference's
``tests/test_config_facade.py`` contracts.  The same sequence of promotions
and overrides runs through both packages, and each resolves the same
settings for its own serve component.
"""
from __future__ import annotations

import warnings

import pytest

from repro.core import config as jconfig
from repro.core import configstore as jstore
import repro.runtime.serve_loop  # noqa: F401  (registers serve_batching)
from repro_torch.core import config
from repro_torch.core import configstore
from repro_torch.core.agent import make_session
from repro_torch.core.configstore import ConfigStore, Context
from repro_torch.core.registry import default_instance, get_component, settings_for
from repro_torch.runtime import serve_loop

COMP = "torch_serve_batching"


@pytest.fixture
def store(tmp_path):
    st = ConfigStore(tmp_path / "configstore")
    old = configstore.set_default_store(st)
    yield st
    configstore.set_default_store(old)


@pytest.fixture
def both_stores(tmp_path):
    t, j = ConfigStore(tmp_path / "t"), jstore.ConfigStore(str(tmp_path / "j"))
    old_t, old_j = configstore.set_default_store(t), jstore.set_default_store(j)
    yield t, j
    configstore.set_default_store(old_t)
    jstore.set_default_store(old_j)


# ----------------------------------------------------------------- resolve
def test_resolve_returns_declared_defaults_when_nothing_tuned(store):
    assert config.resolve(COMP, "no-such-workload") == get_component(COMP).space.defaults()


def test_resolve_sees_promotions_and_overrides_in_tier_order(store):
    base = config.resolve(COMP, "wlA")
    assert config.promote(COMP, {**base, "sync_interval": 9}, workload="wlA")
    assert config.resolve(COMP, "wlA")["sync_interval"] == 9
    config.override(COMP, "wlA", {"sync_interval": 13})
    assert config.resolve(COMP, "wlA")["sync_interval"] == 13
    config.clear_override(COMP, "wlA")
    assert config.resolve(COMP, "wlA")["sync_interval"] == 9
    assert config.resolve(COMP, "wlB")["sync_interval"] == base["sync_interval"]


def test_override_validates_against_the_declared_space(store):
    with pytest.raises(KeyError):
        config.override(COMP, "wlA", {"not_a_knob": 1})
    config.override(COMP, "wlA", {"sync_interval": "7"})
    assert config.resolve(COMP, "wlA")["sync_interval"] == 7
    config.clear_override(COMP, "wlA")


def test_unknown_component_raises(store):
    with pytest.raises(KeyError):
        config.resolve("no_such_component")


def test_resolve_returns_a_fresh_dict(store):
    got = config.resolve(COMP, "wlA")
    got["sync_interval"] = 63
    assert config.resolve(COMP, "wlA")["sync_interval"] != 63


def test_a_cuda_entry_is_invisible_to_a_cpu_resolve(store):
    """The port's one deviation: an entry tuned on another hardware platform
    never resolves, through the facade as through the store."""
    ctx = Context(COMP, "wlA", "cuda:NVIDIA_H100_80GB_HBM3:x1", configstore.sw_fingerprint())
    store.put(ctx, {"sync_interval": 11})
    assert config.resolve(COMP, "wlA", hardware="cuda:NVIDIA_H100_80GB_HBM3:x1") \
        ["sync_interval"] == 11
    assert config.resolve(COMP, "wlA", hardware="cpu:x86_64:x1")["sync_interval"] == \
        get_component(COMP).space.defaults()["sync_interval"]


def test_rpi_keywords_reach_the_store_gate(store):
    from repro_torch.core.rpi import RPI, Bound

    rpi = RPI(COMP, "wlA", (Bound("tokens_per_s", low=100.0),))
    assert not config.promote(COMP, {"sync_interval": 5}, workload="wlA", rpi=rpi,
                              metrics={"tokens_per_s": 50.0})
    assert store.resolve_entry(configstore.context_for(COMP, "wlA")) is None
    assert config.promote(COMP, {"sync_interval": 5}, workload="wlA", rpi=rpi,
                          metrics={"tokens_per_s": 150.0})
    assert config.resolve(COMP, "wlA")["sync_interval"] == 5


# ------------------------------------------------- parity with the reference
@pytest.mark.parametrize("steps", [
    [("promote", "wlA", {"sync_interval": 9})],
    [("promote", "wlA", {"sync_interval": 9}), ("override", "wlA", {"admission": 2})],
    [("promote", "*", {"prefill_chunk": 32}), ("promote", "wlB", {"max_batch": 16})],
    [("override", "wlB", {"max_new_tokens": 7}), ("clear", "wlB", None)],
], ids=["promote", "promote+override", "wildcard+exact", "override+clear"])
def test_facade_resolves_what_the_reference_resolves(both_stores, steps):
    for kind, wl, kv in steps:
        for facade, comp in ((config, COMP), (jconfig, "serve_batching")):
            if kind == "promote":
                assert facade.promote(comp, kv, workload=wl)
            elif kind == "override":
                facade.override(comp, wl, kv)
            else:
                facade.clear_override(comp, wl)
    try:
        for wl in ("wlA", "wlB", "wlC", "*"):
            assert config.resolve(COMP, wl) == jconfig.resolve("serve_batching", wl), wl
    finally:
        for wl in ("wlA", "wlB"):
            config.clear_override(COMP, wl)
            jconfig.clear_override("serve_batching", wl)


# ----------------------------------------------------- registry module level
def test_default_instance_is_the_module_singleton():
    assert default_instance(COMP) is serve_loop.serve_settings
    assert default_instance("no_such_component") is None


def test_settings_for_context_honours_all_coordinates(store):
    hw, sw = configstore.hardware_fingerprint(), configstore.sw_fingerprint()
    store.put(Context(COMP, "wlA", hw, sw), {"sync_interval": 6})
    assert settings_for(Context(COMP, "wlA"))["sync_interval"] == 6
    assert settings_for(Context(COMP, "wlA", hw, sw))["sync_interval"] == 6
    assert settings_for(Context(COMP, "wlZ"))["sync_interval"] == \
        get_component(COMP).space.defaults()["sync_interval"]
    # a stored entry out of the tunable's domain drops to the lower tiers
    store.put(Context(COMP, "wlB", hw, sw), {"sync_interval": 10_000, "bogus": 1})
    got = settings_for(Context(COMP, "wlB"))
    assert "bogus" not in got and got["sync_interval"] == 4


# ------------------------------------------------- deprecated global tier
def test_global_tier_warns_and_still_works(store):
    inst = default_instance(COMP)
    before, explicit = dict(inst.settings), set(inst._explicit_settings)
    try:
        with pytest.warns(DeprecationWarning):
            config.apply_global(COMP, {"admission": 5})
        assert inst.settings["admission"] == 5
        with pytest.warns(DeprecationWarning):
            assert config.global_settings(COMP)["admission"] == 5
        # a key set live on the singleton outranks a stored entry
        store.put(configstore.context_for(COMP, "wlA"), {"admission": 9, "sync_interval": 9})
        got = config.resolve(COMP, "wlA")
        assert got["admission"] == 5 and got["sync_interval"] == 9
    finally:
        inst.settings = before
        inst._explicit_settings = explicit


def test_resolve_does_not_warn(store):
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        config.resolve(COMP, "wlA")


# ------------------------------------------------------------ make_session
def test_make_session_packed_from_registered_component():
    s = make_session(COMP, "tokens_per_s", workload="wl1", mode="max", optimizer="rs",
                     budget=7, seed=3)
    meta = get_component(COMP)
    assert s.component == COMP and s.component_id == meta.component_id
    assert s.metric_names == [m.name for m in meta.metrics] and s.metric_fmt
    assert s.objective == "tokens_per_s" and s.mode == "max"
    assert s.context["component"] == COMP and s.context["workload"] == "wl1"
    assert set(s.context) == {"component", "workload", "hardware", "sw"}


def test_make_session_validates_objective_against_declared_metrics():
    with pytest.raises(ValueError, match="objective"):
        make_session(COMP, "no_such_metric")


def test_make_session_workload_none_skips_context_tagging():
    assert make_session(COMP, "tokens_per_s", workload=None).context is None
