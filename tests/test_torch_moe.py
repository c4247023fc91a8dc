"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``): router, balance loss, the capacity
dispatch of every strategy, gradients, bf16, the ``torch_moe_dispatch``
component, and that nothing in a MoE forward or decode step depends on a
value read back to the host.

Inputs and weights are drawn with numpy from ``zlib.crc32`` seeds and given
to both packages.  Tolerances: float32 outputs 2e-5 absolute and relative
(tests/test_kernels.py's ``_tol`` for float32: the two packages differ only
in summation order), gradients 1e-5, bf16 ``_tol(bf16)`` = 2e-2; expert
ids, keep masks and capacity must be identical.
"""
import dataclasses
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.registry import get_component as jget_component
from repro.models import moe as JMoE
from repro_torch.configs import get_config
from repro_torch.core.registry import get_component
from repro_torch.launch import tuning
from repro_torch.models import model as M
from repro_torch.models import moe

F32 = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _cfgs(e=4, k=2, d=64, f=64):
    base = dict(moe_num_experts=e, moe_top_k=k, d_model=d, moe_d_ff=f)
    return (dataclasses.replace(jget_config("olmoe-1b-7b").reduced(), **base).validate(),
            dataclasses.replace(get_config("olmoe-1b-7b").reduced(), **base).validate())


def _draw(tag, b, s, e, d=64, f=64, skew=0.0):
    """x (B, S, d) and the four leaves, float32, all O(1).  ``skew`` shifts
    x and the router's first two columns so most tokens pick experts 0 and
    1 (their logits gain 4·skew²)."""
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    x = rng.standard_normal((b, s, d)).astype(np.float32) + skew
    p = {"router": rng.standard_normal((d, e)).astype(np.float32) / math.sqrt(d),
         "wi_gate": rng.standard_normal((e, d, f)).astype(np.float32) / math.sqrt(d),
         "wi_up": rng.standard_normal((e, d, f)).astype(np.float32) / math.sqrt(d),
         "wo": rng.standard_normal((e, f, d)).astype(np.float32) / math.sqrt(f)}
    if skew:
        p["router"][:, :2] += 4.0 * skew / d
    return x, p


def _t(tree, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _ref_keep(ids, e, cap):
    """The reference's keep mask (its apply_moe lines, which it returns not)."""
    flat = ids.reshape(-1)
    onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    rank = (jnp.cumsum(onehot, axis=0) - onehot)[jnp.arange(flat.shape[0]), flat]
    return np.asarray(rank < cap)


# ------------------------------------------------------------------ router
def test_route_matches_reference():
    jcfg, cfg = _cfgs(e=8, k=3)
    x, p = _draw("route", 2, 16, 8)
    jg, ji, jp = JMoE._route(p, x.reshape(32, 64), jcfg)
    g, i, pr = moe._route(_t(p), torch.from_numpy(x.reshape(32, 64)), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(g), _np(jg), **F32)
    np.testing.assert_allclose(_np(pr), _np(jp), **F32)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_route_breaks_ties_to_the_lower_id(sign):
    """Three experts tie exactly (zero router columns); the top-3 takes the
    lower ids first in both packages, above or below the fourth."""
    jcfg, cfg = _cfgs(e=4, k=3)
    x, p = _draw(("tie", sign), 1, 8, 4)
    x = np.abs(x)
    p["router"][:, :3] = 0.0
    p["router"][:, 3] = sign / 8           # logit 3 above (below) the tie for every token
    _, ji, _ = JMoE._route(p, x[0], jcfg)
    _, i, _ = moe._route(_t(p), torch.from_numpy(x[0]), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    tied = i.numpy()[i.numpy() != 3].reshape(8, -1)
    assert (np.diff(tied, axis=1) > 0).all()


def test_router_aux_loss_matches_reference():
    jcfg, cfg = _cfgs(e=8, k=2)
    x, p = _draw("aux", 3, 8, 8)
    _, ji, jp = JMoE._route(p, x.reshape(24, 64), jcfg)
    want = JMoE.router_aux_loss(jp, ji, 8)
    _, i, pr = moe._route(_t(p), torch.from_numpy(x.reshape(24, 64)), cfg)
    got = moe.router_aux_loss(pr, i, 8)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# ---------------------------------------------------------------- dispatch
CASES = {   # name: (B, S, E, k, cf, skew)
    "drops": (2, 8, 4, 2, 1.0, 0.5),       # skewed router at capacity factor 1: drops
    "no-drops": (2, 8, 4, 2, 4.0, 0.0),    # cap = max(k, 4·T·k/E) ≥ T: nothing drops
    "wide": (1, 24, 8, 3, 1.25, 0.0),      # odd k, a non-pow2 T
    "decode": (3, 1, 4, 2, 1.25, 0.5),     # T 3: cap = max(k, ...) = 2
}


@pytest.mark.parametrize("strategy", ["gather", "local_tp", "dense", "auto"])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_reference(strategy, case):
    b, s, e, k, cf, skew = CASES[case]
    jcfg, cfg = _cfgs(e=e, k=k)
    x, p = _draw(("moe", case), b, s, e, skew=skew)
    jy, jaux = JMoE.apply_moe(p, x, jcfg, strategy=strategy, capacity_factor=cf)
    y, aux = moe.apply_moe(_t(p), torch.from_numpy(x), cfg, strategy=strategy,
                           capacity_factor=cf)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), **F32)
    np.testing.assert_allclose(_np(aux), _np(jaux), **F32)
    # the same plan: expert ids, capacity and keep mask
    t = b * s
    cap = moe.capacity(t, e, k, cf)
    assert cap == int(max(k, math.ceil(cf * t * k / e)))
    _, ji, _ = JMoE._route(p, x.reshape(t, -1), jcfg)
    _, ids, _ = moe._route(_t(p), torch.from_numpy(x.reshape(t, -1)), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    _, keep, slot = moe.dispatch_plan(ids, e, cap)
    np.testing.assert_array_equal(keep.numpy(), _ref_keep(ji, e, cap))
    assert (slot[~keep] == cap).all() and (slot[keep] < cap).all()
    dropped = float(moe.dropped_frac(_t(p), torch.from_numpy(x), cfg, capacity_factor=cf))
    assert dropped == pytest.approx(1.0 - keep.float().mean().item())
    if case == "drops":
        assert dropped > 0
    if case == "no-drops":
        assert dropped == 0
        yd, _ = moe.apply_moe(_t(p), torch.from_numpy(x), cfg, strategy="dense")
        np.testing.assert_allclose(_np(y), _np(yd), **F32)


@pytest.mark.parametrize("t,e,k,cf", [(1, 64, 8, 1.25), (8, 64, 8, 1.25), (1024, 64, 8, 1.0),
                                      (3, 8, 2, 1.25), (8192, 8, 2, 2.0), (5, 4, 2, 4.0)])
def test_capacity_is_the_references_formula(t, e, k, cf):
    assert moe.capacity(t, e, k, cf) == int(max(k, math.ceil(cf * t * k / e)))


def test_dropped_assignments_contribute_nothing():
    """Every token picks experts 0 and 1 (a zero router but for a large
    margin on them); at cap 2 only the first two tokens are kept, so every
    later token's output is exactly 0, and the kept ones equal the dense
    oracle's."""
    jcfg, cfg = _cfgs(e=4, k=2)
    x, p = _draw("dropall", 1, 6, 4)
    x = np.abs(x)
    p["router"][:] = 0.0
    p["router"][:, :2] = 1.0
    y, _ = moe.apply_moe(_t(p), torch.from_numpy(x), cfg, strategy="gather",
                         capacity_factor=1.0)
    assert moe.capacity(6, 4, 2, 1.0) == 3
    yd, _ = moe.apply_moe(_t(p), torch.from_numpy(x), cfg, strategy="dense")
    assert (y[0, 3:] == 0).all()
    np.testing.assert_allclose(_np(y[0, :3]), _np(yd[0, :3]), **F32)
    jy, _ = JMoE.apply_moe(p, x, jcfg, strategy="gather", capacity_factor=1.0)
    np.testing.assert_allclose(_np(y), _np(jy), **F32)


@pytest.mark.parametrize("strategy", ["gather", "dense"])
@pytest.mark.parametrize("case", ["drops", "no-drops"])
def test_gradients_match_jax(strategy, case):
    """d/d(x, leaves) of sum(y·r) + aux against ``jax.grad``."""
    b, s, e, k, cf, skew = CASES[case]
    jcfg, cfg = _cfgs(e=e, k=k)
    x, p = _draw(("grad", case), b, s, e, skew=skew)
    r = np.random.default_rng(zlib.crc32(repr(("r", case)).encode())).standard_normal(
        x.shape).astype(np.float32)

    def jloss(xx, pp):
        y, aux = JMoE.apply_moe(pp, xx, jcfg, strategy=strategy, capacity_factor=cf)
        return jnp.sum(y * r) + aux

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(x, p)
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k_: v.requires_grad_(True) for k_, v in _t(p).items()}
    y, aux = moe.apply_moe(tp, tx, cfg, strategy=strategy, capacity_factor=cf)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jgx), **GRAD)
    for name in p:
        np.testing.assert_allclose(_np(tp[name].grad), _np(jgp[name]), **GRAD, err_msg=name)


@pytest.mark.parametrize("strategy", ["gather", "dense"])
def test_bf16_matches_reference(strategy):
    b, s, e, k, cf, skew = CASES["drops"]
    jcfg, cfg = _cfgs(e=e, k=k)
    x, p = _draw("bf16", b, s, e, skew=skew)
    jp = {k_: jnp.asarray(v, jnp.bfloat16) for k_, v in p.items()}
    jy, jaux = JMoE.apply_moe(jp, jnp.asarray(x, jnp.bfloat16), jcfg, strategy=strategy,
                              capacity_factor=cf)
    y, aux = moe.apply_moe(_t(p, torch.bfloat16), torch.from_numpy(x).bfloat16(), cfg,
                           strategy=strategy, capacity_factor=cf)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(jy), **BF16)
    np.testing.assert_allclose(_np(aux), _np(jaux), **BF16)


# ---------------------------------------------------------------- component
def test_moe_dispatch_component_is_the_references():
    meta, jmeta = get_component("torch_moe_dispatch"), jget_component("moe_dispatch")
    assert meta.name == "torch_moe_dispatch" and "." not in meta.name
    assert moe.moe_settings.mlos_meta is meta
    assert meta.space.names == jmeta.space.names
    for name in meta.space.names:
        a, b = meta.space[name], jmeta.space[name]
        assert (a.kind, a.default, a.choices, a.low, a.high) == \
            (b.kind, b.default, b.choices, b.low, b.high), name
    assert [m.name for m in meta.metrics] == [m.name for m in jmeta.metrics]
    assert tuning.SINGLETONS["torch_moe_dispatch"] is moe.moe_settings
    for t, e, k in [(1, 64, 8), (8, 64, 8), (1000, 8, 2), (8192, 8, 2), (3, 4, 2)]:
        assert moe.workload_signature(t, e, k) == JMoE.workload_signature(t, e, k)


def test_an_override_changes_the_capacity(monkeypatch):
    """``--set torch_moe_dispatch.capacity_factor=2.0`` casts, validates and
    applies: the layer's capacity grows and fewer assignments drop; a
    context override reaches only its workload."""
    monkeypatch.setattr(moe.moe_settings, "settings", dict(moe.moe_settings.settings))
    monkeypatch.setattr(moe.moe_settings, "_explicit_settings",
                        set(moe.moe_settings._explicit_settings))
    _, cfg = _cfgs(e=4, k=2)
    x, p = _draw("override", 2, 8, 4, skew=0.5)
    before = float(moe.dropped_frac(_t(p), torch.from_numpy(x), cfg))
    wl = moe.workload_signature(16, 4, 2)
    assert moe.moe_settings.settings_for(wl)["capacity_factor"] == 1.25
    over = tuning.parse_override("torch_moe_dispatch.capacity_factor=2.0")
    assert over == {"torch_moe_dispatch": {"capacity_factor": 2.0}}
    tuning.apply_overrides(over)
    assert moe.moe_settings.settings_for(wl)["capacity_factor"] == 2.0
    after = float(moe.dropped_frac(_t(p), torch.from_numpy(x), cfg))
    assert moe.capacity(16, 4, 2, 2.0) > moe.capacity(16, 4, 2, 1.25) and after < before
    with pytest.raises(ValueError):
        tuning.parse_override("torch_moe_dispatch.strategy=expert_parallel")
    assert tuning.current_settings(contexts=False)["torch_moe_dispatch"]["capacity_factor"] == 2.0


# ------------------------------------------------------- no host reads
def _fake(tree, mode):
    if isinstance(tree, dict):
        return {k: _fake(v, mode) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake(v, mode) for v in tree]
    return mode.from_tensor(tree)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mixtral-8x22b"])
def test_moe_forward_and_decode_run_on_fake_tensors(name):
    """Under ``FakeTensorMode`` a value read back to the host (``.item()``,
    ``nonzero``, a boolean mask) raises: the MoE layer, a prefill and a
    per-slot decode step run there, so every shape follows from (T, E, k,
    cf) and a captured step reads nothing back."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(name).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with FakeTensorMode() as mode:
        with pytest.raises(Exception):                  # the check has teeth
            torch.nonzero(mode.from_tensor(torch.ones(3)))
        fp = _fake(params, mode)
        x = mode.from_tensor(torch.zeros((3, 5, cfg.d_model)))
        for strategy in moe.STRATEGIES:
            y, aux = moe.apply_moe(fp["blocks"][0]["moe"], x, cfg, strategy=strategy)
            assert y.shape == x.shape and aux.shape == ()
        toks = mode.from_tensor(torch.zeros((3, 8), dtype=torch.long))
        logits, caches, pos = M.prefill(fp, cfg, toks, 32)
        assert logits.shape == (3, cfg.padded_vocab)
        caches = _fake(M.init_cache(cfg, 3, 32, device="cpu"), mode)
        tok = mode.from_tensor(torch.zeros((3,), dtype=torch.long))
        pos = mode.from_tensor(torch.tensor([8, 3, 40]))
        logits, _ = M.decode_step(fp, cfg, tok, caches, pos)
        assert logits.shape == (3, cfg.padded_vocab)
