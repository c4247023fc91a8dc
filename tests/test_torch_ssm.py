"""The port's SSM and hybrid families (``repro_torch.models``) against the
reference's: reduced mamba2-780m (attention-free Mamba-2) and reduced
hymba-1.5b (attention ∥ SSM averaged, GQA, a 16-token sliding window).

The reference initializes the parameters; ``jax.device_get`` turns them
into numpy and ``repro_torch.convert.params_from_reference`` loads them into
the port.  Tokens are drawn with numpy from ``zlib.crc32`` seeds.
Everything runs in float32 on the CPU, where the two packages differ only
in summation order: the tolerance is 1e-4 absolute and relative on logits
and caches of O(1) magnitude, as in tests/test_torch_model.py.

Prefill widths: 2 (shorter than the conv history of 3: the history is
left-padded), 24 (non-pow2; longer than hymba's window, so its K/V ring is
rolled) and 32 (the capacity).
"""
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.runtime.serve_loop import BatchedServer as JServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models import model as M
from repro_torch.runtime.serve_loop import BatchedServer

TOL = dict(rtol=1e-4, atol=1e-4)
CAPACITY = 32
NAMES = ["mamba2-780m", "hymba-1.5b"]
NEAR_TIE = 1e-4


def _configs(name):
    return jget_config(name).reduced().validate(), get_config(name).reduced().validate()


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


def _assert_caches(tc, jc, n_layers, msg=""):
    """Port caches (list of per-layer dicts) vs the reference's stacked tree."""
    for i in range(n_layers):
        for key in ("k", "v"):
            if key in jc:
                np.testing.assert_allclose(_np(tc[i][key]), _np(jc[key][i]), **TOL,
                                           err_msg=f"{msg} layer {i} {key}")
        for key in ("conv", "ssd"):
            np.testing.assert_allclose(_np(tc[i]["ssm"][key]), _np(jc["ssm"][key][i]), **TOL,
                                       err_msg=f"{msg} layer {i} ssm/{key}")


# ------------------------------------------------------------------- specs
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_reference(name):
    jcfg, tcfg = _configs(name)
    assert _shapes(M.param_specs(tcfg)) == _shapes(JM.param_specs(jcfg))
    assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("name", NAMES)
def test_full_width_param_count_matches_reference(name):
    assert get_config(name).param_count() == jget_config(name).param_count()


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_match_reference(name):
    jcfg, tcfg = _configs(name)
    want = {k: v[1:] for k, v in _shapes(JM.cache_specs(jcfg, 3, CAPACITY)).items()}
    for layer in M.cache_specs(tcfg, 3, CAPACITY):
        assert _shapes(layer) == want
    caches = M.init_cache(tcfg, 3, CAPACITY, dtype="bfloat16", device="cpu")
    assert caches[0]["ssm"]["ssd"].dtype == torch.float32       # the P pin
    assert caches[0]["ssm"]["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_give_each_layer_its_own_dicts(name):
    """Editing one layer's spec leaves every other layer's as it was."""
    specs = M.cache_specs(get_config(name).reduced(), 2, CAPACITY)
    assert len({id(layer) for layer in specs}) == len(specs)
    assert len({id(layer["ssm"]) for layer in specs}) == len(specs)
    del specs[0]["ssm"]
    assert all("ssm" in layer for layer in specs[1:])


# ------------------------------------------------------------------- model
def test_forward_and_logits_match_reference(pair):
    name, jcfg, tcfg, jp, tp = pair
    toks = _tokens(("fwd", name), 2, 24, tcfg.vocab_size)
    jh, _ = JM.forward(jp, jcfg, toks)
    th, _ = M.forward(tp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    np.testing.assert_allclose(_np(M.logits_fn(tp, tcfg, th)), _np(JM.logits_fn(jp, jcfg, jh)),
                               **TOL)


@pytest.mark.parametrize("width", [2, 24, 32])
def test_prefill_and_per_row_decode_match_reference(pair, width):
    """Prefill (logits, every layer's conv history and SSD state, K/V for
    hybrid), then 4 decode steps with per-row positions; both packages
    consume the same tokens."""
    name, jcfg, tcfg, jp, tp = pair
    toks = _tokens(("prefill", name, width), 3, width, tcfg.vocab_size)
    jl, jc, jpos = JM.prefill(jp, jcfg, toks, CAPACITY)
    tl, tc, tpos = M.prefill(tp, tcfg, torch.from_numpy(toks).long(), CAPACITY)
    assert tpos == int(jpos) == width
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _assert_caches(tc, jc, tcfg.n_layers, "prefill")
    assert all(layer["ssm"]["ssd"].dtype == torch.float32 for layer in tc)
    pos = np.array([width, max(width - 1, 1), 1], np.int32)
    rng = np.random.default_rng(zlib.crc32(f"decode/{name}/{width}".encode()))
    for step in range(4):
        tok = rng.integers(0, tcfg.vocab_size, size=(3,)).astype(np.int32)
        jl, jc = JM.decode_step(jp, jcfg, tok, jc, pos + step)
        tl, tc = M.decode_step(tp, tcfg, torch.from_numpy(tok).long(), tc,
                               torch.from_numpy(pos + step).long())
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL, err_msg=f"step {step}")
    _assert_caches(tc, jc, tcfg.n_layers, "decode")


def test_merge_slot_writes_only_its_slot_of_the_nested_state(pair):
    _, _, tcfg, _, _ = pair
    big = M.init_cache(tcfg, 4, CAPACITY, device="cpu")
    _, small, _ = M.prefill(pair[4], tcfg, torch.ones((1, 8), dtype=torch.long), CAPACITY)
    ids = [id(layer["ssm"]["ssd"]) for layer in big]
    out = M.merge_slot(big, small, 2, M.cache_batch_axes(tcfg, 4, CAPACITY))
    assert [id(layer["ssm"]["ssd"]) for layer in out] == ids
    for layer, s in zip(out, small):
        leaves = [("ssm", "conv"), ("ssm", "ssd")] + [(k,) for k in ("k", "v") if k in layer]
        for path in leaves:
            b, w = layer, s
            for k in path:
                b, w = b[k], w[k]
            torch.testing.assert_close(b[2], w[0].to(b.dtype), rtol=0, atol=0)
            assert (b[[0, 1, 3]] == 0).all(), path


# ---------------------------------------------------------------- loading
def test_bf16_load_keeps_the_float32_pins():
    """A bf16 reference tree loads with A_log and dt_bias in float32 and every
    unpinned leaf in bf16, asked for bf16 or not."""
    jcfg, tcfg = _configs("mamba2-780m")
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg, dtype=jnp.bfloat16)
    tree = jax.device_get(jp)
    assert tree["blocks"]["ssm"]["A_log"].dtype == np.float32
    assert tree["blocks"]["ssm"]["wx"].dtype == ml_dtypes.bfloat16
    for dtype in ("bfloat16", None):
        tp = params_from_reference(tree, tcfg, device="cpu", dtype=dtype)
        for layer in tp["blocks"]:
            assert layer["ssm"]["A_log"].dtype == torch.float32, dtype
            assert layer["ssm"]["dt_bias"].dtype == torch.float32, dtype
            assert layer["ssm"]["wx"].dtype == torch.bfloat16, dtype
            assert layer["ssm"]["D"].dtype == torch.bfloat16, dtype
        assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["blocks"][1]["ssm"]["A_log"].numpy(),
                                  tree["blocks"]["ssm"]["A_log"][1])


@pytest.mark.parametrize("name", NAMES)
def test_init_params_pins_and_draws_the_ssm_schemes(name):
    _, cfg = _configs(name)
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype="bfloat16")
    ssm = p["blocks"][0]["ssm"]
    assert ssm["A_log"].dtype == ssm["dt_bias"].dtype == torch.float32
    assert ssm["wx"].dtype == torch.bfloat16
    a = torch.exp(ssm["A_log"])
    assert ((a >= 1.0) & (a <= 16.0)).all()
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert ((dt >= 1e-3 * 0.999) & (dt <= 1e-1 * 1.001)).all()


# ------------------------------------------------------------------ server
@pytest.fixture(scope="module")
def mamba():
    jcfg, cfg = _configs("mamba2-780m")
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_reference(jax.device_get(jparams), cfg, device="cpu")
    return params, cfg, jparams, jcfg


def _prompts(tag, n, lo=1, hi=14):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    return [rng.integers(2, 250, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


def _streams(server):
    return {r.rid: list(r.tokens) for r in server.results.values()}


def _top2_gap_at(params, cfg, prompt, width, stream, t):
    toks = np.zeros((1, width), np.int64)
    n = min(len(prompt), width)
    toks[0, -n:] = prompt[-n:]
    logits, caches, pos = M.prefill(params, cfg, torch.from_numpy(toks), CAPACITY)
    for tok in stream[:t]:
        logits, caches = M.decode_step(params, cfg, torch.tensor([tok]), caches, pos)
        pos += 1
    top = logits[0].topk(2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("mode,settings", [
    ("continuous", {"max_batch": 3, "admission": 2, "prefill_chunk": 16, "sync_interval": 2}),
    ("gang", {"max_batch": 1}),
])
def test_greedy_tokens_match_reference_server(mamba, mode, settings):
    """The port's server and the reference's on the same seeded prompts
    (widths 2…16, prompts of 1…13 tokens): the same greedy tokens, but for
    an argmax whose top-2 gap is under the logit tolerance."""
    params, cfg, jparams, jcfg = mamba
    prompts = _prompts(("parity", mode), 6)
    srv = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode=mode, settings=settings,
                        device="cpu")
    ref = JServer(jparams, jcfg, capacity=CAPACITY, eos_id=-1, mode=mode, settings=settings)
    for p in prompts:
        srv.submit(p)
        ref.submit(p)
    srv.run(max_new_tokens=6)
    ref.run(max_new_tokens=6)
    got, want = _streams(srv), _streams(ref)
    assert got.keys() == want.keys() and all(len(s) == 6 for s in got.values())
    for rid, stream in got.items():
        if stream == want[rid]:
            continue
        t = next(i for i, (x, y) in enumerate(zip(stream, want[rid])) if x != y)
        gap = _top2_gap_at(params, cfg, prompts[rid], srv._width_of(len(prompts[rid])), stream, t)
        assert gap < NEAR_TIE, (f"request {rid} diverges from the reference at step {t} "
                                f"with a top-2 logit gap of {gap:.3g}: not a near-tie")


@pytest.mark.parametrize("name", NAMES)
def test_continuous_matches_sequential_gang(name):
    """The scheduler contract for the SSM state: continuous batching with
    mixed widths is a pure reordering of one-at-a-time decoding."""
    _, cfg = _configs(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    prompts = _prompts(("mixed", name), 5)

    def serve(mode, settings):
        s = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode=mode,
                          settings=settings, device="cpu")
        for p in prompts:
            s.submit(p)
        s.run(max_new_tokens=6)
        return _streams(s)

    assert serve("continuous", {"max_batch": 3, "admission": 2, "sync_interval": 3}) == \
        serve("gang", {"max_batch": 1})
