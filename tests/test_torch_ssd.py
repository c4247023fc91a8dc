"""The port's SSD primitive (``repro_torch.kernels.ssd``) against the reference
package's, on the same inputs.

Inputs are drawn with numpy from ``zlib.crc32`` seeds and handed to both
packages (bf16 cases round them to bf16 first, so both see the same
values).  Tolerances are tests/test_kernels.py's: ``_grid_tol(dtype,
headroom=4)`` on y — float32 4·170·eps (rounding inside the scan, amplified
over the chunk hand-offs), bfloat16 4·5·2⁻⁸ (inputs and y rounded to bf16,
accumulation in f32) — and 1e-3 on the float32 state (an unbounded sum of
products of the inputs, compared absolute and relative).

The Hopper kernel itself runs only on the card (tests/test_torch_kernel_card.py).
On a CPU tensor its wrapper is the plain ``ssd_chunked``, which is checked
here against the reference's plain versions and the Pallas kernel in
interpret mode.
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
from repro_torch.kernels.ssd import kernel as tkernel
from repro_torch.kernels.ssd import ops as tops
from repro_torch.kernels.ssd import ref as tref

DTYPES = ["float32", "bfloat16"]
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
# (b, s, h, p, n, g): tests/test_kernels.py's SSD shapes (:163, :183, SSD_GRID)
# and a narrow mamba2-like one (P 16, N 32, one group)
KERNEL_SHAPES = [
    (2, 128, 4, 16, 8, 1),
    (1, 128, 4, 32, 16, 2),
    (1, 128, 2, 16, 8, 1),
    (1, 96, 2, 8, 4, 1),
    (2, 72, 4, 16, 8, 2),
    (1, 256, 2, 16, 8, 1),
    (1, 64, 4, 16, 32, 1),
]


def _tol(dtype: str) -> dict:
    t = (5.0 * 2.0 ** -8 if dtype == "bfloat16" else 170.0 * float(np.finfo(np.float32).eps)) * 4.0
    return dict(rtol=t, atol=t)


def _draw(tag, b, s, h, p, n, g, dtype):
    """x, dt (softplus'd), A (< 0), B, C, D as numpy float32; x, B, C
    rounded to ``dtype``."""
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    if dtype == "bfloat16":
        x, B, C = (a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in (x, B, C))
    return x, dt, A, B, C, D


def _both(arrays, dtype):
    """(x, dt, A, B, C, D) as jax arrays and torch tensors; x, B, C in dtype."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cast = (0, 3, 4)
    j = [jnp.asarray(a).astype(jd) if i in cast else jnp.asarray(a) for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(td) if i in cast else torch.from_numpy(a)
         for i, a in enumerate(arrays)]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _state(tag, b, h, p, n):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    return rng.standard_normal((b, h, p, n)).astype(np.float32)


# ------------------------------------------------------- plain versions
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_init", [False, True], ids=["zero_state", "init_state"])
def test_naive_scan_matches_reference(dtype, with_init):
    shape = (2, 24, 4, 8, 4, 2)
    j, t = _both(_draw(("naive", dtype, with_init), *shape, dtype), dtype)
    s0 = _state(("naive0", dtype), 2, 4, 8, 4) if with_init else None
    wy, ws = jref.ssd_naive_scan(*j, init_state=None if s0 is None else jnp.asarray(s0),
                                 return_state=True)
    gy, gs = tref.ssd_naive_scan(*t, init_state=None if s0 is None else torch.from_numpy(s0),
                                 return_state=True)
    assert gy.dtype == t[0].dtype and gs.dtype == torch.float32
    np.testing.assert_allclose(_np(gy), _np(wy), **_tol(dtype))
    np.testing.assert_allclose(_np(gs), _np(ws), **STATE_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("with_init", [False, True], ids=["zero_state", "init_state"])
def test_chunked_matches_reference(dtype, shape, with_init):
    """y and the final state, from a zero or a given initial state."""
    b, s, h, p, n, g = shape
    j, t = _both(_draw(("chunked", shape, dtype), *shape, dtype), dtype)
    s0 = _state(("chunked0", shape), b, h, p, n) if with_init else None
    chunk = jops._align(32, s)
    wy, ws = jref.ssd_chunked(*j, chunk=chunk, return_state=True,
                              init_state=None if s0 is None else jnp.asarray(s0))
    gy, gs = tref.ssd_chunked(*t, chunk=chunk, return_state=True,
                              init_state=None if s0 is None else torch.from_numpy(s0))
    assert gy.dtype == t[0].dtype and gs.shape == (b, h, p, n) and gs.dtype == torch.float32
    np.testing.assert_allclose(_np(gy), _np(wy), **_tol(dtype))
    np.testing.assert_allclose(_np(gs), _np(ws), **STATE_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_does_not_depend_on_the_chunk(dtype):
    shape = (1, 128, 2, 16, 16, 1)
    _, t = _both(_draw(("chunks", dtype), *shape, dtype), dtype)
    y0, s0 = tref.ssd_naive_scan(*t, return_state=True)
    for chunk in (2, 16, 64, 128):
        y, s = tref.ssd_chunked(*t, chunk=chunk, return_state=True)
        np.testing.assert_allclose(_np(y), _np(y0), **_tol(dtype), err_msg=f"chunk {chunk}")
        np.testing.assert_allclose(_np(s), _np(s0), **STATE_TOL, err_msg=f"chunk {chunk}")


def test_chunked_masks_the_exponent_above_the_diagonal():
    """A decay steep enough that exp(cs_i - cs_j) overflows for i < j: the
    plain version never forms inf * 0, so y stays finite."""
    shape = (1, 64, 2, 16, 16, 1)
    x, dt, A, B, C, D = _draw("steep", *shape, "float32")
    A = np.full_like(A, -60.0)
    y, s = tref.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C, D)), chunk=64,
                            return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [1, 2])
def test_decode_step_matches_reference(dtype, g):
    b, h, p, n = 3, 4, 8, 4
    x, dt, A, B, C, D = _draw(("dec", dtype, g), b, 1, h, p, n, g, dtype)
    s0 = _state(("dec0", dtype, g), b, h, p, n)
    j, t = _both((x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D), dtype)
    wy, ws = jref.ssd_decode_step(jnp.asarray(s0), *j)
    gy, gs = tref.ssd_decode_step(torch.from_numpy(s0), *t)
    assert gy.dtype == t[0].dtype and gs.dtype == torch.float32
    np.testing.assert_allclose(_np(gy), _np(wy), **_tol(dtype))
    np.testing.assert_allclose(_np(gs), _np(ws), **STATE_TOL)


def test_decode_steps_continue_the_prefill_state():
    """Prefill S-4 steps chunked, then 4 decode steps: y and state equal one
    naive scan over all S."""
    b, s, h, p, n, g = 2, 20, 2, 8, 4, 1
    _, t = _both(_draw("continue", b, s, h, p, n, g, "float32"), "float32")
    x, dt, A, B, C, D = t
    want_y, want_s = tref.ssd_naive_scan(x, dt, A, B, C, D, return_state=True)
    y, state = tref.ssd_chunked(x[:, :16], dt[:, :16], A, B[:, :16], C[:, :16], D, chunk=8,
                                return_state=True)
    ys = [y]
    for i in range(16, s):
        yi, state = tref.ssd_decode_step(state, x[:, i], dt[:, i], A, B[:, i], C[:, i], D)
        ys.append(yi[:, None])
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(want_y), **_tol("float32"))
    np.testing.assert_allclose(_np(state), _np(want_s), **STATE_TOL)


# ------------------------------------------------ against the TPU kernel
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_plain_matches_pallas_interpret(dtype, shape):
    """The kernel wrapper's CPU route (plain ``ssd_chunked``) against the TPU
    kernel's own numerics (Pallas in interpret mode), y and state.  The
    Pallas kernel adds D·x after rounding y to bf16, the port before: within
    one bf16 rounding, inside the tolerance."""
    b, s, h, p, n, g = shape
    j, t = _both(_draw(("pallas", shape, dtype), *shape, dtype), dtype)
    chunk = jops._align(64, s)
    wy, ws = ssd_pallas(*j, chunk=chunk, return_state=True, interpret=True)
    before = tkernel.ssd.launches
    gy, gs = tkernel.ssd(*t, chunk=64, return_state=True)
    assert tkernel.ssd.launches == before
    np.testing.assert_allclose(_np(gy), _np(wy), **_tol(dtype))
    np.testing.assert_allclose(_np(gs), _np(ws), **STATE_TOL)


# ---------------------------------------------------------------- dispatch
@pytest.mark.parametrize("impl", ["naive", "chunked", "chunked_unrolled", "kernel"])
def test_every_impl_matches_reference_naive(impl):
    shape = (2, 72, 4, 16, 8, 2)
    j, t = _both(_draw(("impl", impl), *shape, "float32"), "float32")
    wy, ws = jref.ssd_naive_scan(*j, return_state=True)
    gy, gs = tops.ssd(*t, impl=impl, chunk=32, return_state=True)
    np.testing.assert_allclose(_np(gy), _np(wy), **_tol("float32"))
    np.testing.assert_allclose(_np(gs), _np(ws), **STATE_TOL)


def test_kernel_impl_on_cpu_tensor_is_the_plain_version(monkeypatch):
    """``impl="kernel"`` (the default) on a CPU tensor reaches ssd_chunked
    and launches nothing."""
    _, t = _both(_draw("dispatch", 1, 40, 2, 16, 16, 1, "float32"), "float32")
    calls = []
    real = tref.ssd_chunked
    monkeypatch.setattr(tref, "ssd_chunked", lambda *a, **kw: calls.append(kw["chunk"]) or real(*a, **kw))
    before = tkernel.ssd.launches
    assert tops.ssd_settings.settings_for("*")["impl"] == "kernel"
    got = tops.ssd(*t)
    assert calls == [40] and tkernel.ssd.launches == before   # chunk 64 aligned to S=40
    torch.testing.assert_close(got, real(*t, chunk=40), rtol=0, atol=0)


def test_kernel_wrapper_raises_off_cpu_and_cuda():
    """No silent fallback: a tensor neither on the CPU nor on a CUDA device
    is refused, never routed to the plain version."""
    x = torch.empty((1, 8, 2, 16), device="meta")
    dt = torch.empty((1, 8, 2), device="meta")
    a = torch.empty((2,), device="meta")
    bc = torch.empty((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.ssd(x, dt, a, bc, bc)


def test_unknown_impl_raises():
    _, t = _both(_draw("unknown", 1, 8, 2, 16, 16, 1, "float32"), "float32")
    with pytest.raises(ValueError, match="unknown ssd impl"):
        tops.ssd(*t, impl="pallas")


@pytest.mark.parametrize("chunk,seq", [(64, 96), (64, 72), (32, 33), (1024, 512), (128, 128),
                                       (64, 2), (64, 24)])
def test_align_matches_reference(chunk, seq):
    assert tops._align(chunk, seq) == jops._align(chunk, seq)


@pytest.mark.parametrize("b,s,h", [(1, 1024, 48), (3, 100, 25), (8, 2, 8)])
def test_workload_signature_matches_reference(b, s, h):
    assert tops.workload_signature(b, s, h) == jops.workload_signature(b, s, h)


def test_component_matches_reference_but_for_the_kernel():
    """``torch_ssd_kernel`` keeps the reference's tunable names; ``pallas``
    becomes ``kernel`` (the default), and ``chunk`` takes the lengths the
    kernel was compiled for."""
    from repro.core.registry import get_component as jget
    from repro_torch.core.registry import get_component

    meta, ref = get_component("torch_ssd_kernel"), jget("ssd_kernel")
    assert meta.space.names == ref.space.names
    assert meta.space["impl"].default == "kernel"
    swap = {"pallas": "kernel"}
    assert meta.space["impl"].choices == tuple(swap.get(c, c) for c in ref.space["impl"].choices)
    assert set(meta.space["chunk"].choices) == set(tkernel.CHUNKS)
    assert meta.space["chunk"].default in tkernel.CHUNKS
    assert all(ref.space["chunk"].low <= c <= ref.space["chunk"].high for c in tkernel.CHUNKS)
