"""The port's VLM family (``repro_torch.models``, family ``vlm``) against the
reference's, on ``llama-3.2-vision-11b`` reduced to two groups (4 layers,
``cross_attn_period`` 2: each group one cross-attention block over the
modal tokens, then 2 dense layers; d 64, GQA 4→2, head_dim 16, RMSNorm,
SwiGLU) and 9 modal tokens, a source no tile divides: specs with the two
stacked axes, forward, loss and gradient, prefill (every cache leaf, the
groups' ``xk``, ``xv`` and their inner layers' K/V), per-row decode, the
slot writes through the groups' lists, the server, the train step.

The reference initializes the parameters; ``repro_torch.convert`` loads
them, and both packages get tests/torch_xattn.py's ``perturbed`` changes
(seeded RMSNorm scales, weight matrices scaled by 0.3).  Tokens and modal
tokens are drawn with numpy from ``zlib.crc32`` seeds.  Float32 on the
CPU, 1e-4 absolute and relative (tests/test_torch_encdec.py's tolerances).  The server's stub feeds zero modal tokens:
with no bias the cross-attention's keys and values are then 0 and its
output 0, so the server test holds the group loop and its caches, and the
model tests hold the cross-attention's numbers on drawn modal tokens.
"""
import dataclasses
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
from repro_torch.runtime import steps as S
from repro_torch.runtime.serve_loop import BatchedServer
from repro_torch.tree import leaves, leaves_with_paths, tree_map

import torch_xattn as X

NAME = "llama-3.2-vision-11b"
SCALAR = dict(rel=1e-5, abs=1e-5)
NORM = dict(rel=4 * 170 * float(np.finfo(np.float32).eps))
CAPACITY = 32
MODAL = 9
GROUPS = 2


def _configs():
    return tuple(dataclasses.replace(c.reduced(), n_layers=4, cross_attn_period=2,
                                     num_modal_tokens=MODAL).validate()
                 for c in (jget_config(NAME), get_config(NAME)))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _configs()
    raw = jax.device_get(JM.init_params(jax.random.PRNGKey(zlib.crc32(NAME.encode()) % (1 << 31)),
                                        jcfg))
    tree = X.perturbed(raw, NAME)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_reference(tree, tcfg,
                                                                              device="cpu")


def _frames(tag, b):
    return X.frames(tag, b, MODAL)


def _batch(toks, labels, frames):
    return {"tokens": X.to_t(toks), "labels": X.to_t(labels),
            "modal": X.to_t(frames, torch.float32)}


# ------------------------------------------------------------------- specs
def test_param_specs_match_reference_leaf_for_leaf():
    jcfg, tcfg = _configs()
    got, want = X.specs(M.param_specs(tcfg)), X.specs(JM.param_specs(jcfg))
    assert got == want
    assert got["/xblocks/xattn/wq"][0] == (GROUPS, 64, 4, 16)
    assert got["/blocks/attn/wq"][0] == (GROUPS, 2, 64, 4, 16)
    assert "/xblocks/xattn/q_norm" not in got
    assert tcfg.param_count() == jcfg.param_count()


def test_params_unstack_by_group_and_layer(pair):
    jcfg, tcfg, jp, tp = pair
    assert len(tp["xblocks"]) == GROUPS and set(tp["xblocks"][0]) == {"lnx", "xattn"}
    assert [len(g) for g in tp["blocks"]] == [2] * GROUPS
    np.testing.assert_array_equal(X.to_np(tp["blocks"][1][0]["attn"]["wk"]),
                                  np.asarray(jp["blocks"]["attn"]["wk"][1, 0]))
    units = M.stack_args(tp, tcfg)
    assert len(units) == GROUPS and units[1]["xb"] is tp["xblocks"][1]


def test_full_size_param_count():
    cfg = get_config(NAME)
    assert cfg.param_count() == jget_config(NAME).param_count()
    assert 10.0e9 < cfg.param_count() < 10.2e9


def test_cache_specs_match_reference():
    """One dict per group: its cross cache of ``num_modal_tokens`` whatever
    the context, and its inner layers' self caches."""
    jcfg, tcfg = _configs()
    want = {k: v[0] for k, v in X.specs(JM.cache_specs(jcfg, 3, CAPACITY)).items()}
    got = M.cache_specs(tcfg, 3, CAPACITY)
    assert len(got) == GROUPS and [len(g["inner"]) for g in got] == [2] * GROUPS
    shapes = X.restack(M.init_cache(tcfg, 3, CAPACITY, device="cpu"))
    assert {k: v.shape for k, v in _flat(shapes).items()} == want
    assert got[0]["xk"].shape == (3, MODAL, tcfg.n_kv_heads, tcfg.hd)
    axes = M.cache_batch_axes(tcfg, 3, CAPACITY)
    assert axes[1] == {"xk": 0, "xv": 0, "inner": [{"k": 0, "v": 0}] * 2}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ------------------------------------------------------------------- model
def test_forward_matches_reference(pair):
    jcfg, tcfg, jp, tp = pair
    toks, frames = X.tokens("fwd", 2, 24), _frames("fwd", 2)
    jh, _ = JM.forward(jp, jcfg, toks, frames)
    th, taux = M.forward(tp, tcfg, X.to_t(toks), X.to_t(frames, torch.float32))
    X.close(th, jh)
    assert float(taux) == 0.0
    # the modal tokens act: other draws move the hidden states
    th2, _ = M.forward(tp, tcfg, X.to_t(toks), X.to_t(_frames("other", 2), torch.float32))
    assert float((th2 - th).abs().max()) > 1e-2


def test_loss_and_gradient_match_reference(pair):
    jcfg, tcfg, jp, tp = pair
    toks, frames = X.tokens("loss", 2, 16), _frames("loss", 2)
    labels = X.tokens("labels", 2, 16)
    labels[:, -3:] = -1
    (jloss, _), jgrad = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        jp, jcfg, {"tokens": toks, "labels": labels, "modal": frames})
    live = tree_map(lambda x: x.detach().clone().requires_grad_(True), tp)
    loss, _ = M.loss_fn(live, tcfg, _batch(toks, labels, frames))
    assert float(loss.detach()) == pytest.approx(float(jloss), **SCALAR)
    grads = torch.autograd.grad(loss, leaves(live))
    want = dict(leaves_with_paths(params_from_reference(jax.device_get(jgrad), tcfg,
                                                        device="cpu")))
    got = dict(zip((p for p, _ in leaves_with_paths(live)), grads))
    X.grads_close(got, want, NORM["rel"])
    assert np.abs(X.to_np(got["xblocks/1/xattn/wv"])).max() > 0


@pytest.mark.parametrize("width", [2, 24])
def test_prefill_and_per_row_decode_match_reference(pair, width):
    """Prefill (logits, every group's cross cache and inner K/V), then 4
    decode steps of 3 rows at their own positions."""
    jcfg, tcfg, jp, tp = pair
    b = 3
    toks, frames = X.tokens(("prefill", width), b, width), _frames(("prefill", width), b)
    jl, jc, jpos = JM.prefill(jp, jcfg, toks, CAPACITY, frames)
    tl, tc, tpos = M.prefill(tp, tcfg, X.to_t(toks), CAPACITY, X.to_t(frames, torch.float32))
    assert tpos == int(jpos) == width
    X.close(tl, jl)
    X.trees_close(X.restack(tc), jc)
    xv = tc[0]["xv"].clone()
    pos = np.array([width, max(width - 1, 1), width + 5], np.int32)
    r = X.rng("decode", width)
    for step in range(4):
        tok = r.integers(0, tcfg.vocab_size, size=(b,)).astype(np.int32)
        jl, jc = JM.decode_step(jp, jcfg, tok, jc, pos + step)
        tl, tc = M.decode_step(tp, tcfg, X.to_t(tok), tc, X.to_t(pos + step))
        X.close(tl, jl, err_msg=f"step {step}")
    X.trees_close(X.restack(tc), jc)
    assert torch.equal(tc[0]["xv"], xv)


def test_merge_and_install_slot_match_reference(pair):
    """A batch-1 prefill written into slots 1 (merge_slot) and 2
    (install_slot) of a 3-slot state reaches every group's cross cache and
    every inner layer's K/V, as the reference's merge_slot."""
    jcfg, tcfg, jp, tp = pair
    toks, frames = X.tokens("merge", 1, 8), _frames("merge", 1)
    jl, jsmall, _ = JM.prefill(jp, jcfg, toks, CAPACITY, frames)
    tl, tsmall, _ = M.prefill(tp, tcfg, X.to_t(toks), CAPACITY, X.to_t(frames, torch.float32))
    jaxes = JM.cache_batch_axes(jcfg, 3, CAPACITY)
    jbig = JM.init_cache(jcfg, 3, CAPACITY)
    for slot in (1, 2):
        jbig = JM.merge_slot(jbig, jsmall, jnp.asarray(slot, jnp.int32), jaxes)
    axes = M.cache_batch_axes(tcfg, 3, CAPACITY)
    big = M.init_cache(tcfg, 3, CAPACITY, device="cpu")
    ids = [id(t) for _, t in leaves_with_paths(big)]
    M.merge_slot(big, tsmall, 1, axes)
    tok, pos = torch.zeros(3, dtype=torch.long), torch.zeros(3, dtype=torch.long)
    done = torch.ones(3, dtype=torch.bool)
    M.install_slot(big, tsmall, torch.tensor([2]), tok, pos, done, tl, 8, batch_axes=axes)
    assert [id(t) for _, t in leaves_with_paths(big)] == ids
    X.trees_close(X.restack(big), jbig)
    assert (big[1]["inner"][1]["k"][0] == 0).all() and (big[1]["inner"][1]["k"][2] != 0).any()
    assert pos.tolist() == [0, 0, 8] and done.tolist() == [True, True, False]


# ------------------------------------------------------------------ server
@pytest.mark.parametrize("mode,settings", [
    ("continuous", {"max_batch": 3, "admission": 2, "prefill_chunk": 16, "sync_interval": 2}),
    ("gang", {"max_batch": 3}),
])
def test_server_streams_match_reference_server(pair, mode, settings):
    jcfg, tcfg, jp, tp = pair
    prompts = X.prompts(("serve", mode), 6)
    srv = BatchedServer(tp, tcfg, capacity=CAPACITY, eos_id=-1, mode=mode, settings=settings,
                        device="cpu")
    ref = JServer(jp, jcfg, capacity=CAPACITY, eos_id=-1, mode=mode, settings=settings)
    assert srv._enc_len == ref._enc_len == MODAL
    for p in prompts:
        srv.submit(p)
        ref.submit(p)
    srv.run(max_new_tokens=6)
    ref.run(max_new_tokens=6)
    got, want = X.streams(srv), X.streams(ref)
    assert got == want and all(len(s) == 6 for s in got.values())
    assert srv._caches[1]["xk"].shape == (3, MODAL, tcfg.n_kv_heads, tcfg.hd)


# ------------------------------------------------------------------- train
HYPER = dict(base_lr=1e-2, warmup=2, total=20)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_steps_match_reference(pair, mb):
    """Two steps from the same state (drawn moments, step 5), the modal
    tokens in the batch: loss, ce and gradient norm, then the state."""
    jcfg, tcfg, jp, tp = pair
    st = JS.init_train_state(jax.random.PRNGKey(1), jcfg)
    st["params"] = jp
    r = X.rng("moments", NAME)
    st["opt"]["m"] = jax.tree.map(
        lambda x: jnp.asarray(r.normal(0.0, 1e-2, x.shape), jnp.float32), st["opt"]["m"])
    st["opt"]["v"] = jax.tree.map(
        lambda x: jnp.asarray(r.uniform(1e-4, 1e-3, x.shape), jnp.float32), st["opt"]["v"])
    st["opt"]["count"] = jnp.asarray(5, jnp.int32)
    st["step"] = jnp.asarray(5, jnp.int32)
    state = train_state_from_reference(jax.device_get(st), tcfg, device="cpu")
    jstep = jax.jit(JS.make_train_step(jcfg, JS.TrainHyper(**HYPER), microbatches=mb))
    step = S.make_train_step(tcfg, S.TrainHyper(**HYPER), microbatches=mb)
    for i in range(2):
        toks, frames = X.tokens(("train", i), 4, 16), _frames(("train", i), 4)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        st, jm = jstep(st, {"tokens": toks, "labels": labels, "modal": frames})
        state, m = step(state, _batch(toks, labels, frames))
        for key in ("loss", "ce"):
            assert float(m[key]) == pytest.approx(float(jm[key]), **SCALAR), (i, key)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), **NORM), i
    ref = dict(leaves_with_paths(train_state_from_reference(jax.device_get(st), tcfg,
                                                            device="cpu")))
    for path, got in leaves_with_paths(state):
        np.testing.assert_allclose(got.float().numpy(), ref[path].float().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=path)


def test_train_state_round_trip():
    """The reference's VLM state (``xblocks`` stacked by group, ``blocks``
    by group and layer) → the port's → restacked: the same arrays."""
    jcfg, tcfg = _configs()
    st = jax.device_get(JS.init_train_state(jax.random.PRNGKey(3), jcfg))
    state = train_state_from_reference(st, tcfg, device="cpu")
    for part, want in ((state["params"], st["params"]), (state["opt"]["m"], st["opt"]["m"]),
                       (state["opt"]["v"], st["opt"]["v"])):
        X.trees_close(X.restack(part), want, rtol=0, atol=0)
    assert len(S.train_state_specs(tcfg)["params"]["blocks"]["attn"]["wq"].shape) == 5
