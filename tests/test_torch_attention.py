"""The port's attention (``repro_torch.kernels.flash_attention``) against the
reference package's, on the same inputs.

Inputs are drawn with numpy from ``zlib.crc32`` seeds and handed to both
packages.  Tolerances are the reference's ``_grid_tol`` (tests/test_kernels.py):
float32 170·eps (rounding inside the reductions, amplified by the softmax
length), bfloat16 5·2⁻⁸ (inputs rounded to bf16, accumulation in f32, and a
bf16 rounding of the probabilities and the output that the two packages may
place one unit apart).

The Hopper kernel itself runs only on the card: its tests are in
tests/test_torch_kernel_card.py (marked ``cuda``; they import no jax, so
they also run where jax is not installed).  On a CPU tensor the kernel
wrapper returns the plain version, which the tests here check; on any other
non-CUDA tensor it raises.
"""
import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref

ATTN_GRID = [            # (b, s, h, k, d), as tests/test_kernels.py:128
    (1, 96, 2, 1, 32),
    (2, 72, 4, 2, 16),
    (1, 160, 4, 4, 64),
    (1, 33, 2, 1, 16),
    (2, 256, 2, 2, 32),
]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype: str) -> dict:
    t = 5.0 * 2.0 ** -8 if dtype == "bfloat16" else 170.0 * float(np.finfo(np.float32).eps)
    return dict(rtol=t, atol=t)


def _draw(tag, *shapes, dtype="float32"):
    """Seeded normal arrays, rounded to ``dtype`` (kept as numpy float32)."""
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        out = [a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in out]
    return out


def _both(arrays, dtype):
    """The same values as jax arrays and torch tensors of ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(tag, b, sq, sk, h, k, d, dtype):
    return _both(_draw(tag, (b, sq, h, d), (b, sk, k, d), (b, sk, k, d), dtype=dtype), dtype)


# ------------------------------------------------------- plain versions
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ATTN_GRID)
def test_naive_matches_reference(dtype, shape):
    b, s, h, k, d = shape
    (jq, jk, jv), (tq, tk, tv) = _qkv(("naive", shape, dtype), b, s, s, h, k, d, dtype)
    want = jref.naive_attention(jq, jk, jv, causal=True)
    got = tref.naive_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", ATTN_GRID)
@pytest.mark.parametrize("impl", ["scan", "unrolled", "unrolled_full"])
def test_impls_match_reference_naive(dtype, shape, impl):
    """Each plain impl through the port's ops dispatch vs the reference oracle."""
    b, s, h, k, d = shape
    (jq, jk, jv), (tq, tk, tv) = _qkv(("impl", shape, dtype, impl), b, s, s, h, k, d, dtype)
    want = jref.naive_attention(jq, jk, jv, causal=True)
    got = tops.flash_attention(tq, tk, tv, causal=True, impl=impl, block_q=64, block_kv=32)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,q_offset", [(0, 0), (48, 0), (0, 40), (48, 40)])
def test_window_and_q_offset(dtype, window, q_offset):
    """Sliding window 0/48 and q positions shifted by q_offset (chunked
    prefill: 64 queries after 40 cached keys), GQA 4→2."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(("win", dtype, window, q_offset), 1, 64, 64 + q_offset,
                                      4, 2, 32, dtype)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    want = jref.naive_attention(jq, jk, jv, **kw)
    for impl in ("naive", "scan", "unrolled", "kernel"):
        got = tops.flash_attention(tq, tk, tv, impl=impl, block_q=32, block_kv=32, **kw)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype), err_msg=impl)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,blocks", [((1, 96, 2, 1, 32), (32, 32)),
                                          ((1, 64, 4, 2, 16), (32, 16))])
def test_plain_matches_pallas_interpret(dtype, shape, blocks):
    """The plain version against the TPU kernel's own numerics (Pallas in
    interpret mode), causal and windowed."""
    b, s, h, k, d = shape
    (jq, jk, jv), (tq, tk, tv) = _qkv(("pallas", shape, dtype), b, s, s, h, k, d, dtype)
    for window in (0, 48):
        want = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                      block_q=blocks[0], block_kv=blocks[1], interpret=True)
        got = tkernel.flash_attention(tq, tk, tv, causal=True, window=window)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype), err_msg=f"window {window}")


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [5, 31, [0, 7, 31]], ids=["scalar5", "scalar31", "per_row"])
def test_decode_matches_reference(dtype, pos):
    b, c, h, k, d = 3, 32, 4, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _both(
        _draw(("dec", dtype, str(pos)), (b, 1, h, d), (b, c, k, d), (b, c, k, d), dtype=dtype),
        dtype)
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = torch.tensor(pos) if isinstance(pos, list) else pos
    want = jref.decode_attention(jq, jk, jv, jpos)
    got = tops.decode_attention(tq, tk, tv, tpos)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("pos", [[3, 15, 16, 40], [70, 71, 72, 100]], ids=["filling", "wrapped"])
def test_decode_ring_buffer(pos):
    """Windowed cache (C == window): once pos >= C every slot is valid."""
    b, c, h, k, d = 4, 16, 2, 1, 16
    (jq, jk, jv), (tq, tk, tv) = _both(
        _draw(("ring", str(pos)), (b, 1, h, d), (b, c, k, d), (b, c, k, d)), "float32")
    want = jref.decode_attention(jq, jk, jv, jnp.asarray(pos, jnp.int32), window=c)
    got = tref.decode_attention(tq, tk, tv, torch.tensor(pos), window=c)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


# ---------------------------------------------------------------- dispatch
def test_kernel_impl_on_cpu_tensor_is_the_plain_version(monkeypatch):
    """``impl="kernel"`` (the default) on a CPU tensor reaches naive_attention
    and launches nothing."""
    (_, _, _), (tq, tk, tv) = _qkv("dispatch", 1, 40, 40, 4, 2, 16, "float32")
    calls = []
    real = tref.naive_attention
    monkeypatch.setattr(tref, "naive_attention", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    before = tkernel.flash_attention.launches
    assert tops.attention_settings.settings_for("*")["impl"] == "kernel"
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert calls == [1] and tkernel.flash_attention.launches == before
    torch.testing.assert_close(got, real(tq, tk, tv, causal=True), rtol=0, atol=0)


def test_kernel_wrapper_raises_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device is refused, never routed to the plain version."""
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention(q, q, q)


@pytest.mark.parametrize("block,seq", [(64, 96), (64, 72), (32, 33), (2048, 512), (128, 128),
                                       (512, 24)])
def test_align_matches_reference(block, seq):
    assert tops._align(block, seq) == jops._align(block, seq)


@pytest.mark.parametrize("b,sq,sk,d", [(1, 512, 512, 128), (3, 100, 700, 64), (8, 1, 2048, 128)])
def test_workload_signature_matches_reference(b, sq, sk, d):
    assert tops.workload_signature(b, sq, sk, d) == jops.workload_signature(b, sq, sk, d)


def test_component_name_is_distinct_from_reference():
    from repro.core.registry import get_component as jget
    from repro_torch.core.registry import get_component

    meta = get_component("torch_flash_attention")
    assert meta.space["impl"].default == "kernel"
    assert set(meta.space.names) == set(jget("flash_attention").space.names)
    assert jget("flash_attention").space["impl"].default == "unrolled"
