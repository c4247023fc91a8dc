"""The yardstick's FLOP and byte counts against hand counts at small shapes,
and the frozen parameter count against the port's own."""
import dataclasses

import pytest

from perfbench.lib.spec import ROOT, load_json
from perfbench.lib.yardstick import (PEAK_BF16, active_params, attention_work, bound_s,
                                     matrix_params, serve_flops, train_flops)
from perfbench.reference.model import RefConfig

M = RefConfig(name="t", family="dense", n_layers=2, d=8, n_heads=2, n_kv_heads=1, hd=4, d_ff=16,
              vocab=300, norm="layernorm_np", rope_theta=1e4, tie=False)


def test_attention_work_by_hand():
    b, f = attention_work(1, 3, 2, 1, 4, 2)
    assert b == 2 * 4 * (2 * 3 * 2 + 2 * 3 * 1)          # q, o at 2 heads; k, v at 1
    assert f == 4.0 * 4 * 2 * 6                            # 6 causal pairs a head
    _, fw = attention_work(1, 4, 1, 1, 4, 2, window=2)
    assert fw == 4.0 * 4 * (3 + 2 * 2)                     # w(w+1)/2 + (S-w)·w pairs


def test_bound_is_the_larger_term():
    assert bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert bound_s(0.0, PEAK_BF16 * 2) == pytest.approx(2.0)


def test_serve_flops_by_hand():
    per_layer = 8 * 4 * (2 * 2 + 2 * 1) + 3 * 8 * 16       # q, o, k, v and the SwiGLU
    assert matrix_params(M) == {"layer": per_layer, "head": 8 * 300}
    # a prefill of 3 tokens: 6 causal pairs; one logits row
    assert serve_flops(M, 3, 0, 1) == 2 * 3 * 2 * per_layer + 4 * 2 * 4 * 2 * 6 + 2 * 8 * 300
    # the decode step after 5 tokens attends 6 positions
    assert serve_flops(M, 1, 5, 1) == 2 * 2 * per_layer + 4 * 2 * 4 * 2 * 6 + 2 * 8 * 300


def test_moe_counts_the_router_and_top_k_experts():
    moe = dataclasses.replace(M, family="moe", n_experts=4, top_k=2, d_ff=16)
    assert matrix_params(moe)["layer"] == 8 * 4 * 6 + 8 * 4 + 2 * 3 * 8 * 16


def test_train_flops_is_chip_smokes_formula():
    n = active_params(M)
    assert train_flops(M, 2, 16) == 6.0 * n * 32 + 12.0 * 2 * 4 * 2 * 32 * (16 - 16 * 16 / 32)


@pytest.mark.parametrize("name", ["olmo-1b", "olmoe-1b-7b"])
def test_active_params_equals_the_ports_count(name):
    from perfbench.lib.program import model_config

    spec = load_json(ROOT / "perfbench" / "configs" / f"{name}.json")
    assert active_params(RefConfig.from_file(spec)) == model_config(spec).active_param_count()


def test_full_size_counts_as_published():
    olmo = RefConfig.from_file(load_json(ROOT / "perfbench" / "configs" / "olmo-1b.json"))
    olmoe = RefConfig.from_file(load_json(ROOT / "perfbench" / "configs" / "olmoe-1b-7b.json"))
    assert 1.17e9 < active_params(olmo) < 1.19e9           # tied: 1.18 B
    assert 1.25e9 < active_params(olmoe) < 1.30e9          # 1.28 B active of 6.92 B
