"""The port's train path against the reference's: the train step
(``repro_torch.runtime.steps``), the chunked cross-entropy, the remat
policies, the kernels' autograd Functions and an 8-step ``run_training``.

The reference initializes the state (``repro.runtime.steps.init_train_state``);
``repro_torch.convert.train_state_from_reference`` loads it into the port,
and the moments are replaced by numpy draws (mid-training values: Adam's
first steps divide each gradient element by its own magnitude, which turns
a last-bit difference of a near-zero gradient into a visible update, while
drawn moments make the update a smooth function of the gradient).  Tokens
and labels are drawn with numpy from ``zlib.crc32`` seeds.

Tolerances, float32 on the CPU: the two packages differ in summation
order only.  Loss and gradient norm: 170·eps relative, headroom 4 (the
forward is a chain of such reductions; tests/test_kernels.py's float32
grid tolerance).  Parameters and moments after the step: 1e-5 absolute
and relative (O(1) parameters; an lr of 1e-2 scales an O(170·eps) relative
gradient difference).  The kernels' backward: tests/test_kernels.py's
float32 grid tolerance, 170·eps, with the SSD's headroom of 4.
"""
import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.flash_attention import ref as jattn_ref
from repro.kernels.ssd import ref as jssd_ref
from repro.models import model as JM
from repro.runtime import steps as JS
from repro.runtime import train_loop as jtrain_loop
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_reference
from repro_torch.core import configstore
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import model as M
from repro_torch.models.transformer import stack_workload
from repro_torch.runtime import steps as S
from repro_torch.runtime import train_loop
from repro_torch.tree import leaves, leaves_with_paths, tree_map

EPS = float(np.finfo(np.float32).eps)
SCALAR = dict(rel=4 * 170 * EPS)
STATE = dict(rtol=1e-5, atol=1e-5)
GRID = dict(rtol=170 * EPS, atol=170 * EPS)
NAMES = ["olmo-1b", "mamba2-780m", "hymba-1.5b"]
B, SEQ = 4, 32
HYPER = dict(base_lr=1e-2, warmup=2, total=20)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Reduced models on a CPU shared with the other test workers: one
    intra-op thread in this process and, through ``OMP_NUM_THREADS``, in
    the child interpreters it starts (eight threads per worker spin
    against each other and slow every worker several-fold)."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _rng(*tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _batch(name, vocab):
    rng = _rng("batch", name)
    toks = rng.integers(0, vocab, (B, SEQ)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, SEQ)).astype(np.int32)
    labels[:, -3:] = -1                              # padded tail
    return toks, labels


def _reference_state(name, jcfg):
    """The reference's state at step 5, moments drawn."""
    st = JS.init_train_state(jax.random.PRNGKey(zlib.crc32(name.encode()) % (1 << 31)), jcfg)
    rng = _rng("moments", name)
    st["opt"]["m"] = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0.0, 1e-2, x.shape), jnp.float32), st["opt"]["m"])
    st["opt"]["v"] = jax.tree.map(
        lambda x: jnp.asarray(rng.uniform(1e-4, 1e-3, x.shape), jnp.float32), st["opt"]["v"])
    st["opt"]["count"] = jnp.asarray(5, jnp.int32)
    st["step"] = jnp.asarray(5, jnp.int32)
    return st


@pytest.fixture(scope="module", params=[(n, mb) for n in NAMES for mb in (1, 2)],
                ids=lambda p: f"{p[0]}-mb{p[1]}")
def reference_step(request):
    """(name, microbatches, the reference's state before and after one
    jitted step, its metrics, the batch)."""
    name, mb = request.param
    jcfg = jget_config(name).reduced().validate()
    before = _reference_state(name, jcfg)
    toks, labels = _batch(name, jcfg.vocab_size)
    step = jax.jit(JS.make_train_step(jcfg, JS.TrainHyper(**HYPER), microbatches=mb))
    after, metrics = step(before, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
                          1.5)
    return (name, mb, jax.device_get(before), jax.device_get(after),
            {k: float(v) for k, v in metrics.items()}, (toks, labels))


def _with_remat(cfg, remat):
    wl = stack_workload(cfg.family, B, SEQ, cfg.n_layers)
    configstore.set_override("torch_layer_stack", wl, {"remat": remat})
    return wl


def _port_step(name, mb, before, batch, remat):
    cfg = get_config(name).reduced().validate()
    state = train_state_from_reference(before, cfg, device="cpu")
    wl = _with_remat(cfg, remat)
    try:
        step = S.make_train_step(cfg, S.TrainHyper(**HYPER), microbatches=mb)
        tb = {"tokens": torch.from_numpy(batch[0]).long(),
              "labels": torch.from_numpy(batch[1]).long()}
        return cfg, *step(state, tb, 1.5)
    finally:
        configstore.clear_override("torch_layer_stack", wl)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_train_step_matches_reference(reference_step, remat):
    name, mb, before, after, want, batch = reference_step
    cfg, state, metrics = _port_step(name, mb, before, batch, remat)
    for key in ("loss", "grad_norm", "lr"):
        assert float(metrics[key]) == pytest.approx(want[key], **SCALAR), key
    assert int(state["step"]) == 6 and int(state["opt"]["count"]) == 6
    ref = dict(leaves_with_paths(train_state_from_reference(after, cfg, device="cpu")))
    for path, got in leaves_with_paths(state):
        assert got.dtype == ref[path].dtype, path
        np.testing.assert_allclose(got.float().numpy(), ref[path].float().numpy(), **STATE,
                                   err_msg=path)


@pytest.mark.parametrize("n_layers", [2, 16])
def test_initial_grad_norm_matches_reference_at_depth(n_layers):
    """The loss and gradient norm at initialization of reduced OLMo-1B with
    ``n_layers`` layers (16 is OLMo-1B's depth) equal the reference's.  In
    both the norm grows several-fold a layer (the non-parametric LayerNorm
    divides each layer's gradient by the small rms of a residual stream
    that starts at the embedding's 0.02 scale), so the large norm of a
    full-depth step is the model's, not the port's.  At that depth the
    reference's own norm moves by a percent when its weights move by one
    float32 rounding (relative 2**-23): the gradient there is that badly
    conditioned.  The tolerance is the scalar one or 4 times the larger move
    of the reference's norm under two such perturbations, whichever is
    larger."""
    jcfg = dataclasses.replace(jget_config("olmo-1b").reduced(), n_layers=n_layers).validate()
    st = JS.init_train_state(jax.random.PRNGKey(n_layers), jcfg)
    toks, labels = _batch("olmo-1b", jcfg.vocab_size)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(JS.cast_for_compute(p, jcfg), jcfg, jbatch)[0]))

    def norm(params):
        loss, g = value_and_grad(params)
        return float(loss), float(jnp.sqrt(sum(jnp.sum(jnp.square(x))
                                                for x in jax.tree.leaves(g))))

    want_loss, want = norm(st["params"])
    rng = _rng("perturb", n_layers)
    moves = [abs(norm(jax.tree.map(
        lambda x: x * (1 + 2.0 ** -23 * jnp.asarray(rng.standard_normal(x.shape), x.dtype)),
        st["params"]))[1] - want) / want for _ in range(2)]

    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), n_layers=n_layers).validate()
    params = train_state_from_reference(jax.device_get(st), cfg, device="cpu")["params"]
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    it = iter(live)
    loss, _ = M.loss_fn(tree_map(lambda _: next(it), params), cfg,
                        {"tokens": torch.from_numpy(toks).long(),
                         "labels": torch.from_numpy(labels).long()})
    got = float(torch.sqrt(sum(torch.sum(g * g) for g in torch.autograd.grad(loss, live))))
    assert float(loss.detach()) == pytest.approx(want_loss, **SCALAR)
    assert got == pytest.approx(want, rel=max(SCALAR["rel"], 4 * max(moves)))


def test_cast_for_compute_keeps_pins_and_identity():
    """Leaves already in the compute dtype come back as they are (gradients
    reach them); the SSM's pinned float32 leaves stay float32."""
    cfg = get_config("hymba-1.5b").reduced().validate()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cast = S.cast_for_compute(params, cfg)
    for (path, a), b in zip(leaves_with_paths(params), leaves(cast)):
        assert a is b, path
        want = torch.float32 if path.endswith(("A_log", "dt_bias")) else torch.bfloat16
        assert b.dtype == want, path


def test_train_state_specs_match_reference():
    """The state's spec tree, leaf for leaf, in the reference's order."""
    for name in NAMES:
        jcfg, tcfg = jget_config(name).reduced(), get_config(name).reduced()
        j = jax.tree.leaves(JS.train_state_specs(jcfg), is_leaf=lambda x: hasattr(x, "logical"))
        t = [p for _, p in leaves_with_paths(S.train_state_specs(tcfg))]
        assert [(p.shape, p.logical) for p in t] == [(p.shape, p.logical) for p in j]
        # the reference's stacking drops a leaf's pin (the SSM's float32
        # A_log, dt_bias), the port's keeps it; every pin the reference
        # keeps, the port has too
        assert all(b.dtype in (None, a.dtype) for a, b in zip(t, j))


def test_loss_chunks_agree_and_padded_vocab_is_masked():
    """A ``loss_chunk`` of half the sequence (two chunks, each recomputed in
    the backward pass) gives the loss and gradients of one chunk, and the
    loss is the cross-entropy over the real vocab (the padded columns are
    masked out)."""
    cfg = get_config("olmo-1b").reduced().validate()
    cfg = dataclasses.replace(cfg, vocab_size=250)    # padded to 256
    params = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = _rng("chunks")
    seq = 256
    batch = {"tokens": torch.from_numpy(rng.integers(0, 250, (2, seq))).long(),
             "labels": torch.from_numpy(rng.integers(-1, 250, (2, seq))).long()}
    wl = stack_workload(cfg.family, 2, seq, cfg.n_layers)
    out = {}
    for chunk in (seq, seq // 2):
        configstore.set_override("torch_layer_stack", wl, {"loss_chunk": chunk})
        try:
            live = [p.detach().requires_grad_(True) for p in leaves(params)]
            it = iter(live)
            tree = tree_map(lambda _: next(it), params)
            loss, _ = M.loss_fn(tree, cfg, batch)
            out[chunk] = (loss.detach(), torch.autograd.grad(loss, live))
        finally:
            configstore.clear_override("torch_layer_stack", wl)
    (l1, g1), (l2, g2) = out[seq], out[seq // 2]
    assert float(l2) == pytest.approx(float(l1), **SCALAR)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRID)
    with torch.no_grad():   # the padded columns take no probability mass
        logits = (M.forward(params, cfg, batch["tokens"])[0] @ params["out"])[..., :250]
        nll = -torch.log_softmax(logits, -1).gather(-1, batch["labels"].clamp(min=0)[..., None])
        valid = batch["labels"] >= 0
        assert float(l1) == pytest.approx(float(nll[..., 0][valid].mean()), **SCALAR)


# ------------------------------------------------------ the kernels' Functions
def _plain_attention_launch(calls):
    def launch(q, k, v, causal, window, q_offset, block_q, block_kv, scale):
        calls.append(q.shape)
        return attn_ref.naive_attention(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, scale=scale)
    return launch


@pytest.mark.parametrize("window,q_offset", [(0, 0), (8, 0), (0, 16)])
def test_flash_attention_fn_backward_matches_jax_grad(monkeypatch, window, q_offset):
    """The Function's backward (its launch monkeypatched to the plain
    forward) against ``jax.vjp`` of the reference's plain attention: GQA
    4→2, head dim 16, causal, windowed, offset."""
    calls = []
    monkeypatch.setattr(fa_kernel, "_launch", _plain_attention_launch(calls))
    rng = _rng("attn-fn", window, q_offset)
    q, do = (rng.standard_normal((2, 24, 4, 16)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, 24 + q_offset, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa_kernel.FlashAttentionFn.apply(*ins, True, window, q_offset, 64, 64, None)
    assert out.grad_fn is not None and calls == [(2, 24, 4, 16)]
    got = torch.autograd.grad(out, ins, torch.from_numpy(do))
    jout, vjp = jax.vjp(lambda a, b, c: jattn_ref.naive_attention(a, b, c, **kw), q, k, v)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **GRID)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRID)


@pytest.mark.parametrize("with_d,return_state", [(True, False), (True, True), (False, True)])
def test_ssd_fn_backward_matches_jax_grad(monkeypatch, with_d, return_state):
    """The Function's backward (its launch monkeypatched to the plain
    forward) against ``jax.vjp`` of the reference's chunked SSD in x, dt,
    A, B, C and D: G = 2 groups over 4 heads, two chunks, with and without
    the final state as an output."""
    def launch(x, dt, A, B, C, D, chunk, rs):
        out = ssd_ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk, return_state=True)
        return out if rs else (out[0], None)

    monkeypatch.setattr(ssd_kernel, "_launch", launch)
    rng = _rng("ssd-fn", with_d, return_state)
    b, s, h, p, g, n = 2, 32, 4, 16, 2, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    B_, C_ = (rng.standard_normal((b, s, g, n)).astype(np.float32) / 2 for _ in range(2))
    D = rng.standard_normal(h).astype(np.float32) if with_d else None
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32)
    arrays = [a for a in (x, dt, A, B_, C_, D) if a is not None]
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    args = ins + ([None] if D is None else [])
    out = ssd_kernel.SsdFn.apply(*args, 16, return_state)
    outs = out if return_state else (out,)
    cot = (dy, dstate) if return_state else (dy,)
    got = torch.autograd.grad(outs, ins, [torch.from_numpy(c) for c in cot])

    def ref(*a):
        xx, dd, aa, bb, cc = a[:5]
        return jssd_ref.ssd_chunked(xx, dd, aa, bb, cc, a[5] if with_d else None, chunk=16,
                                    return_state=return_state)

    jout, vjp = jax.vjp(ref, *arrays)
    jouts = jout if return_state else (jout,)
    for o, w in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w), **GRID)
    tol = dict(rtol=4 * GRID["rtol"], atol=4 * GRID["atol"])   # the SSD's headroom
    for name, gg, w in zip("x dt A B C D".split(), got, vjp(tuple(map(jnp.asarray, cot))
                                                          if return_state else jnp.asarray(dy))):
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), **tol, err_msg=name)


def test_ssd_refuses_an_init_state_that_requires_grad(monkeypatch):
    """No gradient through an initial state: the wrapper raises instead of
    returning an output that would silently drop it."""
    monkeypatch.setattr(ssd_kernel, "_check", lambda *a: None)
    x = torch.zeros(1, 4, 2, 16)
    dt, A, B_ = torch.ones(1, 4, 2), -torch.ones(2), torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="init_state"):
        ssd_kernel.ssd(x.to("meta"), dt.to("meta"), A.to("meta"), B_.to("meta"), B_.to("meta"),
                       init_state=torch.zeros(1, 2, 16, 16, requires_grad=True))


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("dots", 2), ("full", 2)])
@pytest.mark.parametrize("name", ["olmo-1b", "mamba2-780m"])
def test_train_step_through_the_functions_counts_the_recompute(monkeypatch, name, remat,
                                                               per_layer):
    """The model's attention and SSD calls routed through the kernels'
    Functions (launches monkeypatched to the plain forward, counted as the
    wrappers count): a train step gives the plain path's loss and gradients,
    and each kernel launches layers × (1 + the recompute ``remat`` implies)
    times — the count ``chip_smoke.py``'s train phases hold the card to."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    cfg = get_config(name).reduced().validate()
    params = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    toks, labels = _batch(name, cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}

    def grads():
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        it = iter(live)
        loss, _ = M.loss_fn(tree_map(lambda _: next(it), params), cfg, batch)
        return loss.detach(), torch.autograd.grad(loss, live)

    wl = _with_remat(cfg, remat)
    try:
        want_loss, want = grads()
        counts = {"attn": 0, "ssd": 0}

        def attn(q, k, v, **kw):
            counts["attn"] += 1
            return attn_ref.naive_attention(q, k, v, causal=kw["causal"], window=kw["window"],
                                            q_offset=kw["q_offset"])

        def ssd(x, dt, A, B_, C, D, chunk, rs):
            counts["ssd"] += 1
            out = ssd_ref.ssd_chunked(x, dt, A, B_, C, D, chunk=ssd_ref.align_chunk(
                chunk, x.shape[1]), return_state=True)
            return out if rs else (out[0], None)

        monkeypatch.setattr(fa_kernel, "_launch", lambda q, k, v, causal, window, q_offset, bq,
                            bkv, scale: attn(q, k, v, causal=causal, window=window,
                                             q_offset=q_offset))
        monkeypatch.setattr(ssd_kernel, "_launch", ssd)
        monkeypatch.setattr(attn_ops.kernel, "flash_attention",
                            lambda q, k, v, causal, window, q_offset, block_q, block_kv:
                            fa_kernel.FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                                             block_q, block_kv, None))
        monkeypatch.setattr(ssd_ops.kernel, "ssd",
                            lambda x, dt, A, B_, C, D, chunk, init_state, return_state:
                            ssd_kernel.SsdFn.apply(x, dt, A, B_, C, D, chunk, return_state))
        got_loss, got = grads()
    finally:
        configstore.clear_override("torch_layer_stack", wl)
    assert float(got_loss) == float(want_loss)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRID)
    uses_attn = cfg.family in ("dense", "hybrid")
    assert counts == {"attn": cfg.n_layers * per_layer if uses_attn else 0,
                      "ssd": 0 if uses_attn and cfg.family == "dense" else cfg.n_layers * per_layer}


# ------------------------------------------------------------ run_training
def test_run_training_trajectory_matches_reference(monkeypatch):
    """8 steps of reduced OLMo-1B through both packages' ``run_training``
    from one initial state (the reference's parameters with drawn moments,
    as in the step test: both inits are monkeypatched to return it): the
    same data stream and schedule, and losses, lrs and gradient norms
    within the step tolerance with headroom 8 (8 compounded steps).  The
    lr is 1e-3: at 5e-3 the reduced model's clipped updates (gradient
    norms of 50-170) make the trajectory chaotic, and 8 steps amplify a
    last-bit difference past any float32 tolerance in either package."""
    jcfg = jget_config("olmo-1b").reduced().validate()
    tcfg = get_config("olmo-1b").reduced().validate()
    init = _reference_state("trajectory", jcfg)
    init["opt"]["count"] = jnp.asarray(0, jnp.int32)
    init["step"] = jnp.asarray(0, jnp.int32)
    host = jax.device_get(init)
    monkeypatch.setattr(jtrain_loop, "init_train_state", lambda key, cfg: init)
    monkeypatch.setattr(train_loop, "init_train_state",
                        lambda cfg, gen, device: train_state_from_reference(host, cfg, device))
    hyper = dict(base_lr=1e-3, warmup=2, total=50)
    want = jtrain_loop.run_training(jcfg, n_steps=8, global_batch=2, seq_len=16,
                                    hyper=JS.TrainHyper(**hyper), seed=0)
    got = train_loop.run_training(tcfg, n_steps=8, global_batch=2, seq_len=16,
                                  hyper=S.TrainHyper(**hyper), seed=0, device="cpu")
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got["history"]],
                                   [h[key] for h in want["history"]],
                                   rtol=8 * SCALAR["rel"], err_msg=key)
