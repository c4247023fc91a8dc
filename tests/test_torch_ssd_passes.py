"""The CPU model of the bf16 SSD kernel's three passes
(``repro_torch.kernels.ssd.ref.ssd_passes``, the arithmetic of
``csrc/ssd_tc.cu``) against the reference package's SSD: its
``ssd_chunked``, its ``ssd_naive_scan`` and the TPU kernel itself
(``ssd_pallas`` in interpret mode).

Inputs are drawn with numpy from ``zlib.crc32`` seeds and handed to both
packages.  In float32 the passes are held to tests/test_kernels.py's
float32 tolerance with the scan's headroom (4·170·eps on y, 1e-3 on the
state).  With ``kernel_rounding`` (the scaled operand of the chunk-state
product split into bf16 high + low parts, M and the entering state rounded
to bf16) and bf16 inputs at mamba2-780m's and hymba-1.5b's widths, they are
held to the tolerances the card tests hold the kernel to: 4·5·2⁻⁸ on y and
1e-3 on the float32 state.  Those draws scale B and C by N^-1/4, as the
card tests do, so C·B has unit variance as after the model's projections.
"""
import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as jops
from repro.kernels.ssd import ref as jref
from repro.kernels.ssd.kernel import ssd_pallas
from repro_torch.kernels.ssd import ref as tref

F32_TOL = 4.0 * 170.0 * float(np.finfo(np.float32).eps)
BF16_TOL = 4.0 * 5.0 * 2.0 ** -8
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
# (b, s, h, p, n, g): tests/test_kernels.py's SSD shapes (:163, :183, SSD_GRID)
# and a narrow mamba2-like one, as tests/test_torch_ssd.py takes them
KERNEL_SHAPES = [
    (2, 128, 4, 16, 8, 1),
    (1, 128, 4, 32, 16, 2),
    (1, 128, 2, 16, 8, 1),
    (1, 96, 2, 8, 4, 1),
    (2, 72, 4, 16, 8, 2),
    (1, 256, 2, 16, 8, 1),
    (1, 64, 4, 16, 32, 1),
]
# the served widths (P, N) at a few heads: mamba2-780m, hymba-1.5b (25 heads,
# P 128, N 16), and a ragged S for each
WIDE_SHAPES = [
    (1, 256, 4, 64, 128, 1),
    (1, 200, 4, 64, 128, 1),
    (1, 256, 5, 128, 16, 1),
    (1, 200, 5, 128, 16, 1),
]


def _draw(tag, b, s, h, p, n, g, dtype, bc_scale=1.0):
    """x, dt (softplus'd), A (< 0), B, C, D as numpy float32; x, B, C
    rounded to ``dtype``."""
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * bc_scale).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * bc_scale).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    if dtype == "bfloat16":
        x, B, C = (a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in (x, B, C))
    return x, dt, A, B, C, D


def _both(arrays, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cast = (0, 3, 4)
    j = [jnp.asarray(a).astype(jd) if i in cast else jnp.asarray(a) for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(td) if i in cast else torch.from_numpy(a)
         for i, a in enumerate(arrays)]
    return j, t


def _reference(name, j, s):
    """(y, state) of one of the reference package's SSD functions."""
    if name == "chunked":
        return jref.ssd_chunked(*j, chunk=jops._align(64, s), return_state=True)
    if name == "naive":
        return jref.ssd_naive_scan(*j, return_state=True)
    return ssd_pallas(*j, chunk=jops._align(64, s), return_state=True, interpret=True)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("reference", ["chunked", "naive", "pallas"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("chunk", [32, 64])
def test_passes_in_float32_match_the_reference(reference, shape, chunk):
    """Everything in float32: the three passes are the chunked algorithm,
    whatever the chunk (64 leaves a ragged last chunk at S 72 and 96)."""
    j, t = _both(_draw(("f32", shape), *shape, "float32"), "float32")
    wy, ws = _reference(reference, j, shape[1])
    gy, gs = tref.ssd_passes(*t, chunk=chunk, return_state=True)
    assert gy.dtype == torch.float32 and gs.shape == tuple(ws.shape)
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(_np(gs), _np(ws), **STATE_TOL)


@pytest.mark.parametrize("reference", ["chunked", "naive", "pallas"])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
@pytest.mark.parametrize("chunk", [32, 64])
def test_passes_with_kernel_rounding_stay_inside_the_card_tolerances(reference, shape, chunk):
    """bf16 inputs, rounded where ssd_tc rounds: y within 4·5·2⁻⁸ and the
    float32 state within 1e-3 of each reference."""
    n = shape[4]
    j, t = _both(_draw(("wide", shape), *shape, "bfloat16", bc_scale=n ** -0.25), "bfloat16")
    wy, ws = _reference(reference, j, shape[1])
    gy, gs = tref.ssd_passes(*t, chunk=chunk, kernel_rounding=True, return_state=True)
    assert gy.dtype == torch.bfloat16 and gs.dtype == torch.float32
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(_np(gs), _np(ws), **STATE_TOL)


def test_passes_without_rounding_equal_the_ports_chunked():
    """The port's own plain version, at a ragged S: one function, two
    groupings of the same float32 sums."""
    shape = (2, 100, 4, 16, 16, 2)
    _, t = _both(_draw("port", *shape, "float32"), "float32")
    wy, ws = tref.ssd_chunked(*t, chunk=4, return_state=True)
    gy, gs = tref.ssd_passes(*t, chunk=64, return_state=True)
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(_np(gs), _np(ws), **STATE_TOL)


def test_passes_stay_finite_under_a_steep_decay():
    """exp(cs_i - cs_j) would overflow above the diagonal: the passes never
    take it there, rounded or not."""
    shape = (1, 128, 2, 16, 16, 1)
    x, dt, A, B, C, D = _draw("steep", *shape, "float32")
    t = [torch.from_numpy(a) for a in (x, dt, np.full_like(A, -60.0), B, C, D)]
    for rounding in (False, True):
        y, s = tref.ssd_passes(*t, chunk=64, kernel_rounding=rounding, return_state=True)
        assert torch.isfinite(y).all() and torch.isfinite(s).all()
