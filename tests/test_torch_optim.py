"""The port's optimizer substrate (``repro_torch.optim``) against the
reference's (``repro.optim``): the ``warmup_cosine`` and ``constant``
schedules, the global norm and its clip, and AdamW.

Inputs are drawn with numpy from ``zlib.crc32`` seeds and handed to both.
Float32 tolerance: 170·eps relative and absolute (tests/test_kernels.py's
float32 grid tolerance: rounding inside a reduction over these sizes).
A bfloat16 parameter is updated in float32 and rounded once in both
packages; the two float32 results may sit on either side of a rounding
boundary, so the bf16 tolerance is one bf16 ulp (2⁻⁸ relative).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro_torch.optim import adamw, schedules
from repro_torch.tree import leaves, tree_map

F32 = dict(rtol=170 * float(np.finfo(np.float32).eps), atol=170 * float(np.finfo(np.float32).eps))
BF16 = dict(rtol=2.0 ** -8, atol=2.0 ** -8)
SHAPES = {"embed": (32, 16), "blocks": [{"w": (16, 8), "b": (8,)}, {"w": (16, 8), "b": (8,)}],
          "ln": {"scale": (16,)}}


def _rng(*tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _draw(rng, scale=1.0, low=None):
    def one(shape):
        if low is not None:
            return rng.uniform(low, scale, shape).astype(np.float32)
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return _map_shapes(one, SHAPES)


def _map_shapes(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_shapes(fn, v) for v in tree]
    return fn(tree)


def _torch(tree, dtype=None):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype or torch.float32), tree)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(base_lr=1e-2, warmup=3, total=40),
                                dict(base_lr=5e-4, warmup=0, total=10, min_frac=0.0)])
def test_warmup_cosine_matches_reference(kw):
    for step in (0, 1, 2, 3, 5, 39, 40, 41, 100, 20000):
        want = float(jsched.warmup_cosine(step, **kw))
        assert float(schedules.warmup_cosine(step, **kw)) == pytest.approx(want, rel=1e-6, abs=0)
        as_tensor = schedules.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        assert as_tensor.dtype == torch.float32 and as_tensor.shape == ()
        assert float(as_tensor) == pytest.approx(want, rel=1e-6, abs=0)


def test_constant_matches_reference():
    got = schedules.constant(torch.tensor(7), 1e-3)
    assert got.dtype == torch.float32 and float(got) == float(jsched.constant(7, 1e-3))


def test_global_norm_and_clip_match_reference():
    g = _draw(_rng("clip"), scale=3.0)
    want_norm = float(jadamw.global_norm(_jax(g)))
    assert float(adamw.global_norm(_torch(g))) == pytest.approx(want_norm, rel=F32['rtol'])
    for max_norm in (0.5, 1e6):
        jc, jn = jadamw.clip_by_global_norm(_jax(g), max_norm)
        tc, tn = adamw.clip_by_global_norm(_torch(g), max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=F32['rtol'])
        for a, b in zip(leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(_np(a), np.asarray(b), **F32)


def test_adamw_init_is_float32_zeros():
    p = _torch(_draw(_rng("init")), torch.bfloat16)
    st = adamw.adamw_init(p)
    assert int(st["count"]) == 0 and st["count"].dtype == torch.int32
    for m, v in zip(leaves(st["m"]), leaves(st["v"])):
        assert m.dtype == v.dtype == torch.float32 and not m.any() and not v.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_update_matches_reference(dtype, clip_norm):
    """One update from mid-training moments (count 4, m and v drawn), with
    the clip active (the gradients' norm is far above 1) or off."""
    rng = _rng("adamw", dtype, clip_norm)
    p, g = _draw(rng), _draw(rng, scale=2.0)
    m, v = _draw(rng, scale=1e-2), _draw(rng, scale=1e-3, low=1e-4)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jp, jg = _jax(p, jdt), _jax(g, jdt)
    jst = {"m": _jax(m), "v": _jax(v), "count": jnp.asarray(4, jnp.int32)}
    want_p, want_st, want_stats = jadamw.adamw_update(jg, jst, jp, lr=jnp.float32(3e-3),
                                                      clip_norm=clip_norm)
    tp, tg = _torch(p, tdt), _torch(g, tdt)
    tst = {"m": _torch(m), "v": _torch(v), "count": torch.tensor(4, dtype=torch.int32)}
    got_p, got_st, got_stats = adamw.adamw_update(tg, tst, tp, lr=torch.tensor(3e-3),
                                                  clip_norm=clip_norm)
    assert got_p is tp and got_st["m"] is tst["m"]         # updated in place
    assert int(got_st["count"]) == 5 and got_st["count"].dtype == torch.int32
    assert float(got_stats["grad_norm"]) == pytest.approx(float(want_stats["grad_norm"]),
                                                              rel=F32["rtol"])
    tol = F32 if dtype == "float32" else BF16
    for a, b in zip(leaves(got_p), jax.tree.leaves(want_p)):
        assert a.dtype == tdt
        np.testing.assert_allclose(_np(a), np.asarray(b.astype(jnp.float32)), **tol)
    for key in ("m", "v"):
        for a, b in zip(leaves(got_st[key]), jax.tree.leaves(want_st[key])):
            np.testing.assert_allclose(_np(a), np.asarray(b), **F32)
