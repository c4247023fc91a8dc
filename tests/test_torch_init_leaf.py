"""``init_leaf`` scales its float32 draw in place (one copy of a stacked leaf:
starcoder2-15b's MLP is 24.2 GB in float32), and that changes no bit: the
draw is the same, and the product by the same float32 scalar rounds the same
whether written in place or into a new tensor.  Held here against the
out-of-place formula on every normal and embed leaf of reduced configs, in
float32 and bfloat16."""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.layers import P, init_leaf, spec_leaves


def _out_of_place(gen, p, dtype):
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    std = p.scale / math.sqrt(max(fan_in, 1)) if p.init == "normal" else 0.02
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32)
    return (x * std).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["starcoder2-15b", "olmoe-1b-7b", "llama-3.2-vision-11b"])
def test_init_leaf_is_bit_equal_to_the_out_of_place_scaling(name, dtype):
    leaves = [p for p in spec_leaves(M.param_specs(get_config(name).reduced()))
              if p.init in ("normal", "embed")]
    assert any(len(p.shape) >= 3 for p in leaves) and any(p.scale != 1.0 for p in leaves)
    for i, p in enumerate(leaves):
        got = init_leaf(torch.Generator().manual_seed(i), p, dtype, torch.device("cpu"))
        want = _out_of_place(torch.Generator().manual_seed(i), p, dtype)
        assert got.dtype == dtype and torch.equal(got, want), p


def test_a_wide_leaf_too():
    p = P((3, 96, 384), ("layers", "d_model", "d_ff"), scale=0.7)
    got = init_leaf(torch.Generator().manual_seed(5), p, torch.bfloat16, torch.device("cpu"))
    assert torch.equal(got, _out_of_place(torch.Generator().manual_seed(5), p, torch.bfloat16))
