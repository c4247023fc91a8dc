"""The port's MoE family (``repro_torch.models``, family ``moe``) against
the reference's, on reduced ``olmoe-1b-7b`` (64→4 experts, top-8→2,
QK-norm) and reduced ``mixtral-8x22b`` (8→4 experts, top-2, GQA, a 16-token
sliding window): specs, forward and loss with the balance loss, prefill
and per-slot decode, the server, the train step and the state loader.

The reference initializes the parameters; ``jax.device_get`` turns them
into numpy and ``repro_torch.convert`` loads them into the port.  Tokens
are drawn with numpy from ``zlib.crc32`` seeds.  Everything runs in float32
on the CPU, where the two packages differ only in summation order: 1e-4
absolute and relative on logits and caches of O(1) magnitude (as in
tests/test_torch_model.py), 1e-5 on the scalar loss, cross-entropy and
aux, and tests/test_torch_train.py's 4·170·eps relative on a gradient norm
(the embedding's gradient sums each token's rows in another order; at
reduced Mixtral's norm of ~65 that moves the norm by ~3e-5).  Expert
capacity couples the rows of a batch, so the server is held to the
reference server's streams for the same requests and settings (the
per-batch contract), not to one-at-a-time decoding.
"""
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.runtime import steps as JS
from repro.runtime.serve_loop import BatchedServer as JServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference, train_state_from_reference
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.runtime import steps as S
from repro_torch.runtime.serve_loop import BatchedServer
from repro_torch.tree import leaves_with_paths

TOL = dict(rtol=1e-4, atol=1e-4)
SCALAR = dict(rel=1e-5, abs=1e-5)
NORM = dict(rel=4 * 170 * float(np.finfo(np.float32).eps))
CAPACITY = 64
NAMES = ["olmoe-1b-7b", "mixtral-8x22b"]


def _configs(name):
    return jget_config(name).reduced().validate(), get_config(name).reduced().validate()


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    jcfg, tcfg = _configs(request.param)
    jp = JM.init_params(jax.random.PRNGKey(zlib.crc32(request.param.encode()) % (1 << 31)), jcfg)
    tp = params_from_reference(jax.device_get(jp), tcfg, device="cpu")
    return request.param, jcfg, tcfg, jp, tp


def _rng(*tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _tokens(tag, b, s, vocab):
    return _rng(tag).integers(0, vocab, size=(b, s)).astype(np.int32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_specs(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), tuple(tree.logical), tree.init, tree.scale)}


# ------------------------------------------------------------------- specs
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_reference_leaf_for_leaf(name):
    jcfg, tcfg = _configs(name)
    got, want = _specs(M.param_specs(tcfg)), _specs(JM.param_specs(jcfg))
    assert got == want          # (the reference's tree map sorts each dict's keys)
    assert {"/blocks/moe/router", "/blocks/moe/wi_gate", "/blocks/moe/wi_up",
            "/blocks/moe/wo"} <= set(got)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("name,low,high", [("olmoe-1b-7b", 6.0, 8.0),
                                           ("mixtral-8x22b", 130.0, 148.0)])
def test_full_size_param_counts(name, low, high):
    """tests/test_arch_smoke.py's bands (specs only, nothing allocated), the
    reference's exact counts, and OLMoE's ~1 B active parameters."""
    cfg = get_config(name)
    assert low < cfg.param_count() / 1e9 < high
    assert cfg.param_count() == jget_config(name).param_count()
    assert cfg.active_param_count() == jget_config(name).active_param_count()
    assert cfg.active_param_count() < cfg.param_count()
    if name == "olmoe-1b-7b":
        assert 0.9e9 < cfg.active_param_count() < 1.7e9


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_are_the_attention_caches(name):
    jcfg, tcfg = _configs(name)
    want = {k: v[0][1:] for k, v in _specs(JM.cache_specs(jcfg, 3, CAPACITY)).items()}
    for layer in M.cache_specs(tcfg, 3, CAPACITY):
        assert {k: v[0] for k, v in _specs(layer).items()} == want
    assert set(want) == {"/k", "/v"}
    assert want["/k"][1] == (16 if name == "mixtral-8x22b" else CAPACITY)   # the window's ring


# ------------------------------------------------------------------- model
def test_forward_and_loss_match_reference(pair):
    name, jcfg, tcfg, jp, tp = pair
    toks = _tokens(("fwd", name), 2, 24, tcfg.vocab_size)
    labels = _tokens(("labels", name), 2, 24, tcfg.vocab_size)
    labels[:, -2:] = -1
    jh, jaux = JM.forward(jp, jcfg, toks)
    th, taux = M.forward(tp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    assert float(taux) == pytest.approx(float(jaux), **SCALAR) and float(taux) > 0
    jloss, jparts = JM.loss_fn(jp, jcfg, {"tokens": toks, "labels": labels})
    loss, parts = M.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(toks).long(),
                                       "labels": torch.from_numpy(labels).long()})
    assert float(loss) == pytest.approx(float(jloss), **SCALAR)
    assert float(parts["ce"]) == pytest.approx(float(jparts["ce"]), **SCALAR)
    assert float(parts["aux"]) == pytest.approx(float(jparts["aux"]), **SCALAR)
    assert float(loss) == pytest.approx(float(parts["ce"]) + M.MOE_AUX_WEIGHT * float(taux),
                                        **SCALAR)


@pytest.mark.parametrize("width", [2, 24])
def test_prefill_and_per_slot_decode_match_reference(pair, width, monkeypatch):
    """Prefill (logits, every layer's K/V; at width 24 Mixtral's 16-slot ring
    is rolled), then 4 decode steps of 5 rows at their own positions; both
    packages consume the same tokens.  At 5 rows a step's capacity is 4
    slots an expert, and some assignments drop."""
    name, jcfg, tcfg, jp, tp = pair
    b = 5
    toks = _tokens(("prefill", name, width), b, width, tcfg.vocab_size)
    jl, jc, jpos = JM.prefill(jp, jcfg, toks, CAPACITY)
    tl, tc, tpos = M.prefill(tp, tcfg, torch.from_numpy(toks).long(), CAPACITY)
    assert tpos == int(jpos) == width
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for i in range(tcfg.n_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tc[i][key]), _np(jc[key][i]), **TOL)

    dropped = []
    real = moe.dispatch_plan

    def spy(ids, e, cap):
        out = real(ids, e, cap)
        dropped.append(int((~out[1]).sum()))
        return out

    monkeypatch.setattr(moe, "dispatch_plan", spy)
    pos = np.array([width, max(width - 1, 1), 1, 3, width + 5], np.int32)
    rng = _rng("decode", name, width)
    for step in range(4):
        tok = rng.integers(0, tcfg.vocab_size, size=(b,)).astype(np.int32)
        jl, jc = JM.decode_step(jp, jcfg, tok, jc, pos + step)
        tl, tc = M.decode_step(tp, tcfg, torch.from_numpy(tok).long(), tc,
                               torch.from_numpy(pos + step).long())
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL, err_msg=f"step {step}")
    for i in range(tcfg.n_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tc[i][key]), _np(jc[key][i]), **TOL)
    assert len(dropped) == 4 * tcfg.n_layers and moe.capacity(b, 4, 2, 1.25) == 4
    if name == "mixtral-8x22b":
        assert sum(dropped) > 0


# ------------------------------------------------------------------ server
def _prompts(tag, n, lo=1, hi=30):
    rng = _rng(tag)
    return [rng.integers(2, 250, size=int(k)).astype(np.int32) for k in rng.integers(lo, hi, n)]


def _streams(server):
    return {r.rid: list(r.tokens) for r in server.results.values()}


@pytest.mark.parametrize("mode,settings", [
    ("continuous", {"max_batch": 3, "admission": 2, "prefill_chunk": 16, "sync_interval": 2}),
    ("gang", {"max_batch": 3}),
])
def test_server_streams_match_reference_server(pair, mode, settings):
    """The port's server and the reference's on the same requests and
    settings give the same greedy streams: the same rows share each decode
    step, so the same tokens compete for capacity."""
    name, jcfg, tcfg, jp, tp = pair
    prompts = _prompts(("serve", name, mode), 6)
    srv = BatchedServer(tp, tcfg, capacity=CAPACITY, eos_id=-1, mode=mode, settings=settings,
                        device="cpu")
    ref = JServer(jp, jcfg, capacity=CAPACITY, eos_id=-1, mode=mode, settings=settings)
    for p in prompts:
        srv.submit(p)
        ref.submit(p)
    srv.run(max_new_tokens=6)
    ref.run(max_new_tokens=6)
    got, want = _streams(srv), _streams(ref)
    assert got == want and all(len(s) == 6 for s in got.values())
    assert max(srv._width_of(len(p)) for p in prompts) == 32       # past Mixtral's window


# ------------------------------------------------------------------- train
HYPER = dict(base_lr=1e-2, warmup=2, total=20)


def _reference_state(name, jcfg):
    """The reference's initial parameters at step 5 with drawn moments
    (tests/test_torch_train.py's: Adam's first steps divide each gradient
    element by its own magnitude, so a last-bit difference of a near-zero
    gradient would become a visible update)."""
    st = JS.init_train_state(jax.random.PRNGKey(zlib.crc32(name.encode()) % (1 << 31)), jcfg)
    rng = _rng("moments", name)
    st["opt"]["m"] = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0.0, 1e-2, x.shape), jnp.float32), st["opt"]["m"])
    st["opt"]["v"] = jax.tree.map(
        lambda x: jnp.asarray(rng.uniform(1e-4, 1e-3, x.shape), jnp.float32), st["opt"]["v"])
    st["opt"]["count"] = jnp.asarray(5, jnp.int32)
    st["step"] = jnp.asarray(5, jnp.int32)
    return st


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mb", [1, 2])
def test_train_steps_match_reference(name, mb):
    """Three steps from the same state: loss, ce and aux of each within 1e-5
    (with 2 microbatches aux is reported 0 and ce is the mean loss, as in
    the reference), and the state after them within 1e-5."""
    jcfg, tcfg = _configs(name)
    st = _reference_state(name, jcfg)
    state = train_state_from_reference(jax.device_get(st), tcfg, device="cpu")
    jstep = jax.jit(JS.make_train_step(jcfg, JS.TrainHyper(**HYPER), microbatches=mb))
    step = S.make_train_step(tcfg, S.TrainHyper(**HYPER), microbatches=mb)
    for i in range(3):
        toks = _tokens(("train", name, i), 4, 16, tcfg.vocab_size)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        st, jm = jstep(st, {"tokens": toks, "labels": labels})
        state, m = step(state, {"tokens": torch.from_numpy(toks).long(),
                                "labels": torch.from_numpy(labels).long()})
        for key in ("loss", "ce", "aux"):
            assert float(m[key]) == pytest.approx(float(jm[key]), **SCALAR), (i, key)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), **NORM), i
        assert (float(m["aux"]) > 0) == (mb == 1)
    ref = dict(leaves_with_paths(train_state_from_reference(jax.device_get(st), tcfg,
                                                            device="cpu")))
    for path, got in leaves_with_paths(state):
        np.testing.assert_allclose(got.float().numpy(), ref[path].float().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("name", NAMES)
def test_train_state_from_reference_round_trip(name):
    """The reference's MoE state → the port's (each stacked leaf unstacked
    per layer, ``moe`` leaves included) → restacked: the same arrays."""
    jcfg, tcfg = _configs(name)
    st = jax.device_get(JS.init_train_state(jax.random.PRNGKey(3), jcfg))
    state = train_state_from_reference(st, tcfg, device="cpu")
    assert set(state["params"]["blocks"][0]) == {"ln1", "attn", "ln2", "moe"}
    assert state["params"]["blocks"][1]["moe"]["wi_gate"].shape == (4, 64, 64)

    def restack(port, ref):
        blocks = port["blocks"]
        for key in ref["blocks"]:
            for leaf in ref["blocks"][key]:
                got = np.stack([_np(b[key][leaf]) for b in blocks])
                np.testing.assert_array_equal(got, np.asarray(ref["blocks"][key][leaf]),
                                              err_msg=f"{key}/{leaf}")
        for key in ("embed", "out"):
            np.testing.assert_array_equal(_np(port[key]), np.asarray(ref[key]))

    restack(state["params"], st["params"])
    restack(state["opt"]["m"], st["opt"]["m"])
    restack(state["opt"]["v"], st["opt"]["v"])
    assert int(state["step"]) == int(st["step"]) and math.isfinite(float(state["opt"]["count"]))
