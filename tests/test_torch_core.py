"""The port's copy of the MLOS core (``repro_torch.core``) against the
reference's: the same tunable spaces and bucketing, its own component names
and its own hardware × software coordinates.
"""
import re

import numpy as np
import pytest
import torch

from repro.core import configstore as jstore
from repro.core import tunable as jtunable
from repro.core.registry import all_components as jall
from repro_torch.core import configstore, registry, tunable
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import transformer
from repro_torch.runtime import serve_loop


@pytest.mark.parametrize("n", [1, 2, 3, 5, 64, 100, 512, 513, 4096, 50_000])
def test_bucket_pow2_matches_reference(n):
    assert configstore.bucket_pow2(n) == jstore.bucket_pow2(n)


def test_fingerprints_name_torch_and_this_device():
    hw, sw = configstore.hardware_fingerprint(), configstore.sw_fingerprint()
    if torch.cuda.is_available():
        assert re.fullmatch(r"cuda:\S+:x\d+", hw)
    else:
        assert re.fullmatch(r"cpu:\S+:x1", hw)
    assert sw.startswith(f"torch-{torch.__version__}/cuda-") and "/py-3." in sw
    assert hw != jstore.hardware_fingerprint() and sw != jstore.sw_fingerprint()
    ctx = configstore.context_for("torch_flash_attention", "b1q512k512d128")
    assert ctx.to_dict() == {"component": "torch_flash_attention", "workload": "b1q512k512d128",
                             "hardware": hw, "sw": sw}


def test_resolution_order_override_then_explicit_then_defaults():
    wl = "b1q64k64d16"
    assert ops.attention_settings.settings_for(wl)["block_q"] == 64
    inst = ops.AttentionKernelSettings(block_q=128)           # explicit on this instance
    assert inst.settings_for(wl)["block_q"] == 128
    configstore.set_override("torch_flash_attention", wl, {"block_q": 64, "impl": "naive"})
    try:
        got = inst.settings_for(wl)
        assert got["block_q"] == 64 and got["impl"] == "naive"
        assert inst.settings_for("b1q128k128d16")["block_q"] == 128  # other contexts untouched
    finally:
        configstore.clear_override("torch_flash_attention", wl)
    assert inst.settings_for(wl)["block_q"] == 128


def test_override_is_domain_checked():
    wl = "b2q8k8d16"
    configstore.set_override("torch_flash_attention", wl, {"block_q": 4096})
    try:
        with pytest.raises(ValueError):
            ops.attention_settings.settings_for(wl)
    finally:
        configstore.clear_override("torch_flash_attention", wl)


def test_apply_settings_marks_keys_explicit():
    inst = serve_loop.ServeSettings()
    inst.apply_settings({"sync_interval": 8})
    assert inst.settings_for("dense_c256")["sync_interval"] == 8
    assert inst.settings_for("dense_c256")["max_batch"] == 8


def test_port_components_are_distinct_and_dotless():
    names = {m.name for m in registry.all_components()}
    assert {"torch_flash_attention", "torch_layer_stack", "torch_serve_batching"} <= names
    assert not names & {m.name for m in jall()}
    assert all("." not in n and n.startswith("torch_") for n in names)
    ids = [m.component_id for m in registry.all_components()]
    assert len(ids) == len(set(ids))


def test_layer_stack_keeps_the_reference_tunable_space():
    from repro.models.transformer import stack_settings as jstack

    meta = transformer.stack_settings.mlos_meta
    assert meta.space.names == jstack.mlos_meta.space.names
    assert meta.space.defaults() == jstack.mlos_meta.space.defaults()


@pytest.mark.parametrize("make", [
    lambda m: m.Int("n", default=8, low=1, high=256, log=True),
    lambda m: m.Float("x", default=0.5, low=0.0, high=1.0),
    lambda m: m.Categorical("c", default="b", choices=("a", "b", "c")),
])
def test_tunable_copy_encodes_like_the_reference(make):
    t, j = make(tunable), make(jtunable)
    rng = np.random.default_rng(3)
    for u in rng.random(16):
        assert t.decode(float(u)) == j.decode(float(u))
    assert t.encode(t.default) == pytest.approx(j.encode(j.default))
