"""The Hopper flash-attention kernel on the card, against its plain version.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernel is built at
first use into ``build/kernels/``): they carry the ``cuda`` marker and skip
where ``torch.cuda.is_available()`` is false.  The file imports no jax, so it
runs on a machine that has only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_kernel_card.py

Inputs are drawn with numpy from ``zlib.crc32`` seeds.  Tolerances (absolute
and relative) are tests/test_kernels.py's ``_grid_tol``: bfloat16 5·2⁻⁸ (the
plain version rounds the probabilities to bf16 before the PV product, the
kernel keeps them in f32), float32 170·eps (summation order inside the
reductions).
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel, ops, ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [               # (b, sq, sk, h, k, d)
    (1, 96, 96, 2, 1, 32),
    (2, 72, 72, 4, 2, 16),
    (1, 160, 160, 4, 4, 64),
    (1, 33, 33, 2, 1, 16),
    (2, 256, 256, 2, 2, 32),
    (1, 1024, 1024, 16, 16, 128),   # OLMo-1B prefill at the widest bucket
    (1, 2, 2, 16, 16, 128),
    (1, 100, 228, 8, 8, 64),        # chunked prefill: q after 128 cached keys
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda")


def _tol(dtype: str) -> float:
    return 5.0 * 2.0 ** -8 if dtype == "bfloat16" else 170.0 * float(np.finfo(np.float32).eps)


def _qkv(tag, b, sq, sk, h, k, d, dtype, device):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, DTYPES[dtype])
            for s in ((b, sq, h, d), (b, sk, k, d), (b, sk, k, d))]


def _close(got, want, dtype):
    torch.cuda.synchronize()
    t = _tol(dtype)
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=t, atol=t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("window", [0, 48])
def test_kernel_matches_plain(cuda, dtype, shape, window):
    b, sq, sk, h, k, d = shape
    q, kk, v = _qkv(("card", shape, dtype), b, sq, sk, h, k, d, dtype, cuda)
    kw = dict(causal=True, window=window, q_offset=sk - sq)
    _close(kernel.flash_attention(q, kk, v, **kw), ref.naive_attention(q, kk, v, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("block_q", kernel.TILES)
@pytest.mark.parametrize("block_kv", kernel.TILES)
def test_every_compiled_tile_matches_plain(cuda, block_q, block_kv):
    q, k, v = _qkv(("tiles", block_q, block_kv), 2, 77, 77, 4, 2, 32, "bfloat16", cuda)
    got = kernel.flash_attention(q, k, v, block_q=block_q, block_kv=block_kv)
    _close(got, ref.naive_attention(q, k, v), "bfloat16")


@pytest.mark.cuda
def test_ops_dispatch_launches_the_kernel_and_counts(cuda):
    q, k, v = _qkv("ops", 1, 64, 64, 4, 4, 64, "bfloat16", cuda)
    before = kernel.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert kernel.flash_attention.launches == before + 1
    _close(got, ref.naive_attention(q, k, v), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float16", "head_dim", "strided", "gqa", "tile"])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, bad):
    q, k, v = _qkv("bad", 1, 8, 8, 4, 2, 32, "bfloat16", cuda)
    kw = {}
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = q[..., :24].contiguous(), k[..., :24].contiguous(), v[..., :24].contiguous()
    elif bad == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "gqa":
        q = q[:, :, :3].contiguous()
    else:
        kw = {"block_q": 128}
    before = kernel.flash_attention.launches
    with pytest.raises(ValueError):
        kernel.flash_attention(q, k, v, **kw)
    assert kernel.flash_attention.launches == before
