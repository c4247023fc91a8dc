"""The port's dense model (``repro_torch.models``) against the reference's.

The reference initializes the parameters (a jax.random stream cannot be
replayed in torch); ``jax.device_get`` turns them into numpy and
``repro_torch.convert.params_from_reference`` loads them into the port.
Tokens are drawn with numpy from ``zlib.crc32`` seeds.  Everything runs in
float32 on the CPU, where the two packages differ only in summation order:
the tolerance is 1e-4 absolute and relative on hidden states, logits and
caches of O(1) magnitude (a few hundred f32 roundings through 2 layers).

Configs: four reduced dense configs (olmo-1b: non-parametric LayerNorm,
SwiGLU, GQA 4→2, head_dim 16; deepseek-67b: RMSNorm; command-r-35b: tied
embeddings) and a less-reduced starcoder2-15b with head_dim 64, GQA 4→2, a
16-token sliding window (ring-buffer cache), biases, LayerNorm and GELU.
"""
import dataclasses
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models import model as M

TOL = dict(rtol=1e-4, atol=1e-4)
CAPACITY = 32


def _configs(name):
    j, t = jget_config(name).reduced(), get_config(name).reduced()
    if name == "starcoder2-15b":
        wide = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256)
        j, t = dataclasses.replace(j, **wide), dataclasses.replace(t, **wide)
    return j.validate(), t.validate()


NAMES = ["olmo-1b", "deepseek-67b", "command-r-35b", "starcoder2-15b"]


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    jcfg, tcfg = _configs(request.param)
    jp = JM.init_params(jax.random.PRNGKey(zlib.crc32(request.param.encode()) % (1 << 31)), jcfg)
    tp = params_from_reference(jax.device_get(jp), tcfg, device="cpu")
    return request.param, jcfg, tcfg, jp, tp


def _tokens(tag, b, s, vocab):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    return rng.integers(0, vocab, size=(b, s)).astype(np.int32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_reference(name):
    jcfg, tcfg = _configs(name)
    assert _shapes(M.param_specs(tcfg)) == _shapes(JM.param_specs(jcfg))
    assert tcfg.param_count() == jcfg.param_count()


def test_full_width_olmo_param_count_matches_reference():
    assert get_config("olmo-1b").param_count() == jget_config("olmo-1b").param_count()


def test_forward_and_logits_match_reference(pair):
    name, jcfg, tcfg, jp, tp = pair
    toks = _tokens(("fwd", name), 2, 24, tcfg.vocab_size)
    jh, _ = JM.forward(jp, jcfg, toks)
    th = M.forward(tp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    jl = JM.logits_fn(jp, jcfg, jh)
    tl = M.logits_fn(tp, tcfg, th)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    if tcfg.padded_vocab != tcfg.vocab_size:
        assert (tl[..., tcfg.vocab_size:] == -1e30).all()


def test_prefill_and_per_row_decode_match_reference(pair):
    """Prefill (logits, every layer's K/V cache, pos), then 4 decode steps
    with per-row positions; both packages consume the same tokens."""
    name, jcfg, tcfg, jp, tp = pair
    s = 24   # > the windowed config's 16: its cache is rolled into ring order
    toks = _tokens(("prefill", name), 3, s, tcfg.vocab_size)
    jl, jc, jpos = JM.prefill(jp, jcfg, toks, CAPACITY)
    tl, tc, tpos = M.prefill(tp, tcfg, torch.from_numpy(toks).long(), CAPACITY)
    assert tpos == int(jpos) == s
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for i in range(tcfg.n_layers):
        for kv in ("k", "v"):
            np.testing.assert_allclose(_np(tc[i][kv]), _np(jc[kv][i]), **TOL,
                                       err_msg=f"layer {i} {kv}")
    # rows at different positions: the first keeps going, the others rewrite
    # earlier slots (per-row rope phase, write slot and validity horizon)
    pos = np.array([s, s - 5, s - 11], np.int32)
    rng = np.random.default_rng(zlib.crc32(f"decode/{name}".encode()))
    for step in range(4):
        tok = rng.integers(0, tcfg.vocab_size, size=(3,)).astype(np.int32)
        jl, jc = JM.decode_step(jp, jcfg, tok, jc, pos + step)
        tl, tc = M.decode_step(tp, tcfg, torch.from_numpy(tok).long(), tc,
                               torch.from_numpy(pos + step).long())
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL, err_msg=f"step {step}")
    for i in range(tcfg.n_layers):
        np.testing.assert_allclose(_np(tc[i]["k"]), _np(jc["k"][i]), **TOL)
        np.testing.assert_allclose(_np(tc[i]["v"]), _np(jc["v"][i]), **TOL)


def test_scalar_pos_decode_matches_reference(pair):
    """Gang decode: one shared position given as a Python int."""
    name, jcfg, tcfg, jp, tp = pair
    toks = _tokens(("gang", name), 2, 8, tcfg.vocab_size)
    _, jc, jpos = JM.prefill(jp, jcfg, toks, CAPACITY)
    _, tc, tpos = M.prefill(tp, tcfg, torch.from_numpy(toks).long(), CAPACITY)
    tok = toks[:, -1]
    for step in range(2):
        jl, jc = JM.decode_step(jp, jcfg, tok, jc, jpos + step)
        tl, tc = M.decode_step(tp, tcfg, torch.from_numpy(tok).long(), tc, tpos + step)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_merge_slot_writes_one_row_in_place():
    _, cfg = _configs("olmo-1b")
    big = M.init_cache(cfg, 4, CAPACITY, device="cpu")
    small = [{k: torch.full_like(v[:1], float(i + 1)) for k, v in layer.items()}
             for i, layer in enumerate(M.init_cache(cfg, 1, CAPACITY, device="cpu"))]
    ids = [id(layer["k"]) for layer in big]
    out = M.merge_slot(big, small, 2, M.cache_batch_axes(cfg, 4, CAPACITY))
    assert [id(layer["k"]) for layer in out] == ids
    for i, layer in enumerate(out):
        assert (layer["k"][2] == i + 1).all() and (layer["k"][[0, 1, 3]] == 0).all()


def test_init_params_is_seeded_and_follows_specs():
    _, cfg = _configs("olmo-1b")
    a = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert len(a["blocks"]) == cfg.n_layers
    torch.testing.assert_close(a["blocks"][1]["attn"]["wq"], b["blocks"][1]["attn"]["wq"],
                               rtol=0, atol=0)
    assert a["blocks"][0]["attn"]["wq"].shape == (cfg.d_model, cfg.n_heads, cfg.hd)
    assert a["embed"].dtype == torch.float32
    assert abs(float(a["embed"].std()) - 0.02) < 0.005
