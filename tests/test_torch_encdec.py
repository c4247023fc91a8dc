"""The port's encoder-decoder family (``repro_torch.models``, family
``encdec``) against the reference's, on reduced ``seamless-m4t-medium``
(2 encoder and 2 decoder layers, d 64, GQA 4→2, head_dim 16, LayerNorm
with biases, GELU; vocab 250, so the padded vocabulary's mask runs): specs,
forward and loss with their gradient, prefill (the encoder's non-causal
self-attention, the decoder's causal self-attention and its
cross-attention, every cache leaf ``xk`` and ``xv`` included), per-row
decode, the slot writes, the server, the train step.

The reference initializes the parameters; ``jax.device_get`` turns them
into numpy and ``repro_torch.convert`` loads them into the port.  Both
packages then get the same changes (tests/torch_xattn.py's ``perturbed``):
the zero biases and unit scales get seeded draws, so an encoder fed zero
frames (the server's stub) still gives a source that is not zero and every
leaf acts, and the weight matrices are scaled by 0.3, which keeps the
reduced model out of the regime where float32 rounding is amplified.
Tokens and modal frames are drawn with numpy from ``zlib.crc32`` seeds.
Everything runs in float32 on the CPU: 1e-4 absolute and relative
(tests/test_torch_model.py's), the gradient's leaves at 1e-4 of the
largest leaf absolute, its norm at tests/test_torch_train.py's 4·170·eps.

The reference's ``forward`` (and so its ``loss_fn`` and train step) runs
the decoder stack with the family name as the block kind, which matches no
block: its encdec forward is ``ln_f(embed(tokens))`` whatever the weights
and frames (``test_reference_forward_skips_the_stacks``).  The port runs
the encoder and the decoder, as the reference's ``prefill`` does; the
forward, loss and train tests hold it to the reference's own stacks
composed that way (``_reference_forward``), with ``repro.models.model.forward``
monkeypatched to it for the reference's train step.
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
from repro.models import transformer as JT
from repro.models.layers import apply_norm as japply_norm
from repro.runtime import steps as JS
from repro.runtime.serve_loop import BatchedServer as JServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference, train_state_from_reference
from repro_torch.models import model as M
from repro_torch.runtime import steps as S
from repro_torch.runtime.serve_loop import BatchedServer
from repro_torch.tree import leaves, leaves_with_paths, tree_map

import torch_xattn as X

NAME = "seamless-m4t-medium"
SCALAR = dict(rel=1e-5, abs=1e-5)
NORM = dict(rel=4 * 170 * float(np.finfo(np.float32).eps))
CAPACITY = 32
FRAMES = 6


def _configs():
    j, t = (dataclasses.replace(c.reduced(), vocab_size=250).validate()
            for c in (jget_config(NAME), get_config(NAME)))
    return j, t


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _configs()
    raw = jax.device_get(JM.init_params(jax.random.PRNGKey(zlib.crc32(NAME.encode()) % (1 << 31)),
                                        jcfg))
    tree = X.perturbed(raw, NAME)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_reference(tree, tcfg,
                                                                              device="cpu")


def _frames(tag, b, n=FRAMES):
    return X.frames(tag, b, n)


def _reference_forward(params, cfg, tokens, modal=None):
    """The reference's encoder-decoder forward as its prefill composes it:
    the encoder stack over the frames, the normed encoder output as the
    decoder stack's cross-attention source."""
    x = params["embed"][tokens]
    enc, _ = JT.forward_stack(params["enc"], modal.astype(x.dtype), cfg, kind="encoder")
    src = japply_norm(params["enc_ln_f"], enc, cfg)
    h, aux = JT.forward_stack(params["blocks"], x, cfg, kind="decoder", xattn_src=src)
    return japply_norm(params["ln_f"], h, cfg), aux


def _reference_loss(params, cfg, batch):
    h, aux = _reference_forward(params, cfg, batch["tokens"], batch["modal"])
    return JM._chunked_ce(h, JM._out_weight(params, cfg), batch["labels"], cfg)


# ------------------------------------------------------------------- specs
def test_param_specs_match_reference_leaf_for_leaf():
    jcfg, tcfg = _configs()
    got, want = X.specs(M.param_specs(tcfg)), X.specs(JM.param_specs(jcfg))
    assert got == want
    assert {"/enc/attn/wq", "/enc_ln_f/scale", "/blocks/xattn/wq", "/blocks/lnx/scale",
            "/blocks/xattn/bk"} <= set(got)
    assert tcfg.param_count() == jcfg.param_count()


def test_full_size_param_count():
    cfg = get_config(NAME)
    assert cfg.param_count() == jget_config(NAME).param_count()
    assert 0.85e9 < cfg.param_count() < 0.9e9


def test_cache_specs_match_reference():
    """Per decoder layer: the self cache of the context and the static cross
    cache of ``enc_len`` source positions (the context's without one)."""
    jcfg, tcfg = _configs()
    for enc_len in (FRAMES, None):
        want = {k: v[0] for k, v in X.specs(JM.cache_specs(jcfg, 3, CAPACITY, enc_len)).items()}
        layers = M.cache_specs(tcfg, 3, CAPACITY, enc_len)
        assert len(layers) == tcfg.n_layers
        for layer in layers:
            assert {f"/{k}": (tcfg.n_layers, *p.shape) for k, p in layer.items()} == want
        assert layers[0]["xk"].shape[1] == (enc_len or CAPACITY)
    axes = M.cache_batch_axes(tcfg, 3, CAPACITY, FRAMES)
    assert axes == [{"k": 0, "v": 0, "xk": 0, "xv": 0}] * tcfg.n_layers


# ------------------------------------------------------------------- model
def test_reference_forward_skips_the_stacks(pair):
    """The reference caveat this file works around, pinned: the reference's
    encdec forward is ln_f(embed) whatever the frames; the port's is not."""
    jcfg, tcfg, jp, tp = pair
    toks = X.tokens("caveat", 2, 8)
    jh, _ = JM.forward(jp, jcfg, toks, _frames("caveat", 2))
    np.testing.assert_allclose(X.to_np(jh), X.to_np(japply_norm(jp["ln_f"], jp["embed"][toks], jcfg)),
                               rtol=0, atol=0)
    th, _ = M.forward(tp, tcfg, X.to_t(toks), X.to_t(_frames("caveat", 2), torch.float32))
    assert np.abs(X.to_np(th) - X.to_np(jh)).max() > 1e-2


def test_forward_matches_the_references_stacks(pair):
    jcfg, tcfg, jp, tp = pair
    toks, frames = X.tokens("fwd", 2, 24), _frames("fwd", 2)
    jh, _ = _reference_forward(jp, jcfg, toks, frames)
    th, taux = M.forward(tp, tcfg, X.to_t(toks), X.to_t(frames, torch.float32))
    X.close(th, jh)
    assert float(taux) == 0.0
    with pytest.raises(ValueError, match="modal"):
        M.forward(tp, tcfg, X.to_t(toks))


def test_loss_and_gradient_match_the_references_stacks(pair):
    """The loss (padded-vocab mask, pad labels) and the gradient of every
    leaf, the encoder's and the cross-attention's included."""
    jcfg, tcfg, jp, tp = pair
    toks, frames = X.tokens("loss", 2, 16), _frames("loss", 2)
    labels = X.tokens("labels", 2, 16)
    labels[:, -3:] = -1
    batch = {"tokens": toks, "labels": labels, "modal": frames}
    jloss, jgrad = jax.value_and_grad(_reference_loss)(jp, jcfg, batch)
    live = tree_map(lambda x: x.detach().clone().requires_grad_(True), tp)
    loss, parts = M.loss_fn(live, tcfg, {"tokens": X.to_t(toks), "labels": X.to_t(labels),
                                         "modal": X.to_t(frames, torch.float32)})
    assert float(loss.detach()) == pytest.approx(float(jloss), **SCALAR)
    assert float(parts["ce"].detach()) == pytest.approx(float(jloss), **SCALAR)
    grads = torch.autograd.grad(loss, leaves(live))
    want = dict(leaves_with_paths(params_from_reference(jax.device_get(jgrad), tcfg,
                                                        device="cpu")))
    got = dict(zip((p for p, _ in leaves_with_paths(live)), grads))
    X.grads_close(got, want, NORM["rel"])
    assert np.abs(X.to_np(got["enc/0/attn/wq"])).max() > 0
    assert np.abs(X.to_np(got["blocks/1/xattn/wk"])).max() > 0


@pytest.mark.parametrize("width", [2, 24])
def test_prefill_and_per_row_decode_match_reference(pair, width):
    """Prefill (logits, every layer's K/V, xk and xv), then 4 decode steps
    of 3 rows at their own positions; the cross caches are read, never
    written."""
    jcfg, tcfg, jp, tp = pair
    b = 3
    toks, frames = X.tokens(("prefill", width), b, width), _frames(("prefill", width), b)
    jl, jc, jpos = JM.prefill(jp, jcfg, toks, CAPACITY, frames)
    tl, tc, tpos = M.prefill(tp, tcfg, X.to_t(toks), CAPACITY, X.to_t(frames, torch.float32))
    assert tpos == int(jpos) == width
    X.close(tl, jl)
    X.trees_close(X.restack(tc), jc)
    assert tc[0]["xk"].shape == (b, FRAMES, tcfg.n_kv_heads, tcfg.hd)
    xk = tc[1]["xk"].clone()
    pos = np.array([width, max(width - 1, 1), width + 5], np.int32)
    rng = X.rng("decode", width)
    for step in range(4):
        tok = rng.integers(0, tcfg.vocab_size, size=(b,)).astype(np.int32)
        jl, jc = JM.decode_step(jp, jcfg, tok, jc, pos + step)
        tl, tc = M.decode_step(tp, tcfg, X.to_t(tok), tc, X.to_t(pos + step))
        X.close(tl, jl, err_msg=f"step {step}")
    X.trees_close(X.restack(tc), jc)
    assert torch.equal(tc[1]["xk"], xk)


def test_gang_decode_at_one_shared_position(pair):
    jcfg, tcfg, jp, tp = pair
    toks, frames = X.tokens("gang", 2, 8), _frames("gang", 2)
    _, jc, jpos = JM.prefill(jp, jcfg, toks, CAPACITY, frames)
    _, tc, tpos = M.prefill(tp, tcfg, X.to_t(toks), CAPACITY, X.to_t(frames, torch.float32))
    tok = toks[:, -1]
    for step in range(2):
        jl, jc = JM.decode_step(jp, jcfg, tok, jc, jpos + step)
        tl, tc = M.decode_step(tp, tcfg, X.to_t(tok), tc, tpos + step)
        X.close(tl, jl)


def test_merge_and_install_slot_match_reference(pair):
    """A batch-1 prefill written into slot 1 (merge_slot) and slot 2
    (install_slot, with its registers) of a 3-slot state, cross caches
    included, equals the reference's merge_slot; the other rows stay."""
    jcfg, tcfg, jp, tp = pair
    toks, frames = X.tokens("merge", 1, 8), _frames("merge", 1)
    jl, jsmall, _ = JM.prefill(jp, jcfg, toks, CAPACITY, frames)
    tl, tsmall, _ = M.prefill(tp, tcfg, X.to_t(toks), CAPACITY, X.to_t(frames, torch.float32))
    jaxes = JM.cache_batch_axes(jcfg, 3, CAPACITY, FRAMES)
    jbig = JM.init_cache(jcfg, 3, CAPACITY, FRAMES)
    for slot in (1, 2):
        jbig = JM.merge_slot(jbig, jsmall, jnp.asarray(slot, jnp.int32), jaxes)
    axes = M.cache_batch_axes(tcfg, 3, CAPACITY, FRAMES)
    big = M.init_cache(tcfg, 3, CAPACITY, FRAMES, device="cpu")
    ids = [id(t) for _, t in leaves_with_paths(big)]
    M.merge_slot(big, tsmall, 1, axes)
    tok, pos = torch.zeros(3, dtype=torch.long), torch.zeros(3, dtype=torch.long)
    done = torch.ones(3, dtype=torch.bool)
    M.install_slot(big, tsmall, torch.tensor([2]), tok, pos, done, tl, 8, batch_axes=axes)
    assert [id(t) for _, t in leaves_with_paths(big)] == ids
    X.trees_close(X.restack(big), jbig)
    assert (big[0]["xk"][0] == 0).all() and (big[0]["xk"][1] != 0).any()
    assert tok.tolist() == [0, 0, int(np.argmax(X.to_np(jl)[0]))]
    assert pos.tolist() == [0, 0, 8] and done.tolist() == [True, True, False]


# ------------------------------------------------------------------ server
@pytest.mark.parametrize("mode,settings", [
    ("continuous", {"max_batch": 3, "admission": 2, "prefill_chunk": 16, "sync_interval": 2}),
    ("gang", {"max_batch": 3}),
])
def test_server_streams_match_reference_server(pair, mode, settings):
    """The port's server and the reference's, each feeding its stub's zero
    frames (``enc_len`` = max(2, bucket_pow2(capacity // 4)) = 8), give the
    same greedy streams for the same requests and settings."""
    jcfg, tcfg, jp, tp = pair
    prompts = X.prompts(("serve", mode), 6)
    srv = BatchedServer(tp, tcfg, capacity=CAPACITY, eos_id=-1, mode=mode, settings=settings,
                        device="cpu")
    ref = JServer(jp, jcfg, capacity=CAPACITY, eos_id=-1, mode=mode, settings=settings)
    assert srv._enc_len == ref._enc_len == 8
    for p in prompts:
        srv.submit(p)
        ref.submit(p)
    srv.run(max_new_tokens=6)
    ref.run(max_new_tokens=6)
    got, want = X.streams(srv), X.streams(ref)
    assert got == want and all(len(s) == 6 for s in got.values())
    assert srv._caches[0]["xk"].shape[1] == 8 and (srv._caches[0]["xk"] != 0).any()


# ------------------------------------------------------------------- train
HYPER = dict(base_lr=1e-2, warmup=2, total=20)


def _reference_state(jcfg, tree):
    st = JS.init_train_state(jax.random.PRNGKey(1), jcfg)
    st["params"] = jax.tree.map(jnp.asarray, tree)
    rng = X.rng("moments", NAME)
    st["opt"]["m"] = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0.0, 1e-2, x.shape), jnp.float32), st["opt"]["m"])
    st["opt"]["v"] = jax.tree.map(
        lambda x: jnp.asarray(rng.uniform(1e-4, 1e-3, x.shape), jnp.float32), st["opt"]["v"])
    st["opt"]["count"] = jnp.asarray(5, jnp.int32)
    st["step"] = jnp.asarray(5, jnp.int32)
    return st


@pytest.mark.parametrize("mb", [1, 2])
def test_train_steps_match_reference(pair, mb, monkeypatch):
    """Two steps from the same state, the frames in the batch: loss and ce
    within 1e-5, the gradient norm within 4·170·eps, the state after them
    within 1e-5 (the reference's forward composed as its prefill does)."""
    jcfg, tcfg, jp, tp = pair
    monkeypatch.setattr(JM, "forward", _reference_forward)
    st = _reference_state(jcfg, jax.device_get(jp))
    state = train_state_from_reference(jax.device_get(st), tcfg, device="cpu")
    jstep = jax.jit(JS.make_train_step(jcfg, JS.TrainHyper(**HYPER), microbatches=mb))
    step = S.make_train_step(tcfg, S.TrainHyper(**HYPER), microbatches=mb)
    for i in range(2):
        toks, frames = X.tokens(("train", i), 4, 16), _frames(("train", i), 4)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        st, jm = jstep(st, {"tokens": toks, "labels": labels, "modal": frames})
        state, m = step(state, {"tokens": X.to_t(toks), "labels": X.to_t(labels),
                                "modal": X.to_t(frames, torch.float32)})
        for key in ("loss", "ce"):
            assert float(m[key]) == pytest.approx(float(jm[key]), **SCALAR), (i, key)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), **NORM), i
    ref = dict(leaves_with_paths(train_state_from_reference(jax.device_get(st), tcfg,
                                                            device="cpu")))
    for path, got in leaves_with_paths(state):
        np.testing.assert_allclose(got.float().numpy(), ref[path].float().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=path)


def test_train_state_round_trip():
    """The reference's encdec state → the port's (``enc`` and ``blocks``
    unstacked per layer) → restacked: the same arrays."""
    jcfg, tcfg = _configs()
    st = jax.device_get(JS.init_train_state(jax.random.PRNGKey(3), jcfg))
    state = train_state_from_reference(st, tcfg, device="cpu")
    assert len(state["params"]["enc"]) == tcfg.enc_layers
    assert set(state["params"]["blocks"][0]) == {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    for part, want in ((state["params"], st["params"]), (state["opt"]["m"], st["opt"]["m"]),
                       (state["opt"]["v"], st["opt"]["v"])):
        X.trees_close(X.restack(part), want, rtol=0, atol=0)
