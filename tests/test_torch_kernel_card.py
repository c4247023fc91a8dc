"""The port's Hopper kernels on the card, against their plain versions:
flash attention (``csrc/flash_attention_tc.cu`` for bfloat16, on the tensor
cores; ``csrc/flash_attention.cu`` for float32), the SSD scan
(``csrc/ssd_tc.cu`` for bfloat16, three passes on the tensor cores;
``csrc/ssd.cu`` for float32; both compiled chunks) and row RMSNorm
(``csrc/rmsnorm.cu``).

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels are built at
first use into ``build/kernels/``): they carry the ``cuda`` marker and skip
where ``torch.cuda.is_available()`` is false.  The file imports no jax, so it
runs on a machine that has only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_kernel_card.py

The MoE family (OLMoE-1B-7B, Mixtral-8x22B) has no kernel of its own: its
tests here hold its prefill shapes on the attention kernel, its decode
step captured as a CUDA graph against the eager step, bit for bit, and two
runs of its train step against each other, bit for bit.

Inputs are drawn with numpy from ``zlib.crc32`` seeds.  Tolerances (absolute
and relative) are tests/test_kernels.py's ``_grid_tol``: bfloat16 5·2⁻⁸,
float32 170·eps (summation order inside the reductions; both the plain version and the tensor-core kernel round the
probabilities to bf16 before the PV product); for the SSD y with the headroom 4 that file gives the scan,
and 1e-3 on the float32 state.  The SSD's B and C are drawn with variance
N^-1/2, so C·B has unit variance as after the model's projections: at
N = 128 and unit B, C the terms of y reach ~10², and any two f32 summation
orders then differ by more than the f32 tolerance where y cancels to ~0.
"""
import dataclasses
import os
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

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
    (1, 1024, 1024, 25, 5, 64),     # hymba-1.5b prefill at the widest bucket (GQA 25->5)
]
HYMBA_WIDTHS = [2 ** k for k in range(1, 11)]   # every pow2 prefill width the server gives


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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", HYMBA_WIDTHS)
def test_kernel_matches_plain_at_hymba_prefill(cuda, dtype, width):
    """hymba-1.5b's serving prefills: 25 query heads over 5 KV heads, head
    dim 64, sliding window 2048 (wider than every prompt)."""
    q, kk, v = _qkv(("hymba", width, dtype), 1, width, width, 25, 5, 64, dtype, cuda)
    kw = dict(causal=True, window=2048)
    _close(kernel.flash_attention(q, kk, v, **kw), ref.naive_attention(q, kk, v, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("block_q", kernel.TILES)
@pytest.mark.parametrize("block_kv", kernel.TILES)
def test_every_compiled_tile_matches_plain(cuda, block_q, block_kv):
    q, k, v = _qkv(("tiles", block_q, block_kv), 2, 77, 77, 4, 2, 32, "bfloat16", cuda)
    got = kernel.flash_attention(q, k, v, block_q=block_q, block_kv=block_kv)
    _close(got, ref.naive_attention(q, k, v), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs", [(1, 128), (2, 256), (2, 512), (4, 1024)])
@pytest.mark.parametrize("block_q", kernel.TILES)
@pytest.mark.parametrize("block_kv", kernel.TILES)
def test_every_compiled_tile_matches_plain_at_the_grid_shapes(cuda, dtype, bs, block_q, block_kv):
    """The `kernels` campaign grid times every tile pair at OLMo-1B's heads
    (16 x 128, causal) and may promote any of them; a pair that is not
    compiled for the dtype (float32 128/128 at head_dim 128) is refused."""
    b, s = bs
    q, k, v = _qkv(("grid", bs, dtype), b, s, s, 16, 16, 128, dtype, cuda)
    if not kernel.compiled(DTYPES[dtype], block_q, block_kv, 128):
        with pytest.raises(ValueError, match=f"block_q={block_q}, block_kv={block_kv}"):
            kernel.flash_attention(q, k, v, block_q=block_q, block_kv=block_kv)
        return
    got = kernel.flash_attention(q, k, v, block_q=block_q, block_kv=block_kv)
    _close(got, ref.naive_attention(q, k, v), dtype)


INSTANCES = [(dt, bq, bk, d) for dt in DTYPES for bq in kernel.TILES for bk in kernel.TILES
             for d in kernel.HEAD_DIMS]


@pytest.mark.cuda
@pytest.mark.parametrize("instance", INSTANCES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-d{c[3]}")
@pytest.mark.parametrize("case", ["ragged", "offset_window"])
def test_every_compiled_instance_matches_plain(cuda, instance, case):
    """Every (dtype, block_q, block_kv, head_dim) the sources compile, at a
    ragged GQA shape and at a chunked-prefill shape (q after 128 cached keys)
    under a window; an instance that is not compiled raises and launches
    nothing.  The library's shared-memory size is the wrapper's table's."""
    dtype, bq, bk, d = instance
    b, sq, sk, h, kh, kw = ((2, 77, 77, 4, 2, dict(causal=True)) if case == "ragged" else
                            (1, 100, 228, 4, 2, dict(causal=True, q_offset=128, window=64)))
    q, k, v = _qkv(("instance", instance, case), b, sq, sk, h, kh, d, dtype, cuda)
    if not kernel.compiled(DTYPES[dtype], bq, bk, d):
        before = kernel.flash_attention.launches
        with pytest.raises(ValueError, match=f"block_q={bq}, block_kv={bk}"):
            kernel.flash_attention(q, k, v, block_q=bq, block_kv=bk, **kw)
        assert kernel.flash_attention.launches == before
        return
    want = kernel.smem_bytes(DTYPES[dtype], bq, bk, d)
    assert kernel.library_smem_bytes(DTYPES[dtype], bq, bk, d) == want
    got = kernel.flash_attention(q, k, v, block_q=bq, block_kv=bk, **kw)
    _close(got, ref.naive_attention(q, k, v, **kw), dtype)


TC_SERVED = {            # (b, sq, sk, h, k, d), attention keywords
    "olmo_s1024": ((1, 1024, 1024, 16, 16, 128), dict(causal=True)),
    "olmo_ragged_s1000": ((1, 1000, 1000, 16, 16, 128), dict(causal=True)),
    "olmo_window48": ((1, 300, 300, 16, 16, 128), dict(causal=True, window=48)),
    "olmo_q_offset": ((1, 100, 228, 16, 16, 128), dict(causal=True, q_offset=128)),
    "olmo_not_causal": ((1, 200, 300, 16, 16, 128), dict(causal=False)),
    "hymba_s1024": ((1, 1024, 1024, 25, 5, 64), dict(causal=True, window=2048)),
    "hymba_window300": ((1, 1024, 1024, 25, 5, 64), dict(causal=True, window=300)),
    "hymba_ragged_q_offset": ((2, 37, 165, 25, 5, 64), dict(causal=True, q_offset=128)),
    # seamless-m4t-medium: the encoder over 512 frames, the decoder, cross over the frames
    "seamless_encoder_s512": ((1, 512, 512, 16, 16, 64), dict(causal=False)),
    "seamless_decoder_s1024": ((1, 1024, 1024, 16, 16, 64), dict(causal=True)),
    **{f"seamless_cross_q{w}": ((1, w, 512, 16, 16, 64), dict(causal=False))
       for w in (2, 64, 1024)},
    # llama-3.2-vision-11b: causal GQA 32->8, cross over the 1601 modal tokens
    **{f"vision_s{w}": ((1, w, w, 32, 8, 128), dict(causal=True)) for w in (2, 64, 1024)},
    **{f"vision_cross_q{w}": ((1, w, 1601, 32, 8, 128), dict(causal=False))
       for w in (2, 64, 1024)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", TC_SERVED)
@pytest.mark.parametrize("block_q", kernel.TILES)
@pytest.mark.parametrize("block_kv", kernel.TILES)
def test_tensor_core_kernel_at_the_served_shapes(cuda, name, block_q, block_kv):
    """The bf16 tensor-core path at OLMo-1B's, hymba-1.5b's,
    seamless-m4t-medium's and llama-3.2-vision-11b's widths: causal, sliding
    window, q_offset, ragged, no mask at all, and cross-attention (Sq != Sk,
    a VLM's 1601 keys, which no tile divides)."""
    (b, sq, sk, h, kh, d), kw = TC_SERVED[name]
    q, k, v = _qkv(("served", name), b, sq, sk, h, kh, d, "bfloat16", cuda)
    got = kernel.flash_attention(q, k, v, block_q=block_q, block_kv=block_kv, **kw)
    _close(got, ref.naive_attention(q, k, v, **kw), "bfloat16")


@pytest.mark.cuda
def test_ops_dispatch_launches_the_kernel_and_counts(cuda):
    q, k, v = _qkv("ops", 1, 64, 64, 4, 4, 64, "bfloat16", cuda)
    before = kernel.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert kernel.flash_attention.launches == before + 1
    _close(got, ref.naive_attention(q, k, v), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bad", ["float16", "head_dim", "strided", "gqa", "tile", "misaligned"])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, bad, dtype):
    """No fallback: a call a kernel cannot take raises before any launch,
    for the bf16 tensor-core kernel as for the f32 one."""
    q, k, v = _qkv("bad", 1, 8, 8, 4, 2, 32, dtype, cuda)
    kw = {}
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = q[..., :24].contiguous(), k[..., :24].contiguous(), v[..., :24].contiguous()
    elif bad == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "gqa":
        q = q[:, :, :3].contiguous()
    elif bad == "tile":
        kw = {"block_q": 32}
    else:
        q = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    before = kernel.flash_attention.launches
    with pytest.raises(ValueError):
        kernel.flash_attention(q, k, v, **kw)
    assert kernel.flash_attention.launches == before


# --------------------------------------------------------------------- SSD
SSD_SHAPES = [           # (b, s, h, p, n, g)
    (1, 1024, 48, 64, 128, 1),   # mamba2-780m prefill at the widest bucket
    (1, 2, 48, 64, 128, 1),      # ... and the narrowest
    (1, 64, 48, 64, 128, 1),
    (1, 512, 25, 128, 16, 1),    # hymba-1.5b
    (2, 200, 8, 32, 128, 2),     # G = 2, non-pow2 S, batch 2
    (3, 77, 4, 16, 128, 1),      # P 16 (one 16-column slice), ragged chunk
    (2, 24, 8, 16, 16, 1),       # the reduced configs' shape
    (1, 256, 48, 64, 128, 1),    # the `kernels` campaign grid's two SSD cells
    (2, 512, 48, 64, 128, 1),
    (2, 1024, 25, 8, 16, 1),     # P 8: hymba-1.5b's head-dim shard on a model axis of 16
    (1, 300, 25, 8, 16, 1),      # ... ragged, a ragged head block
    (2, 200, 8, 8, 128, 2),      # ... at N 128, G 2
]


def _ssd_inputs(tag, b, s, h, p, n, g, dtype, device):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) / n ** 0.25).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) / n ** 0.25).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    t = [torch.from_numpy(a).to(device) for a in (x, dt, A, B, C, D)]
    for i in (0, 3, 4):
        t[i] = t[i].to(DTYPES[dtype])
    return t


def _ssd_close(got, want, dtype):
    torch.cuda.synchronize()
    t = 4.0 * _tol(dtype)
    (gy, gs), (wy, ws) = got, want
    assert gy.dtype == wy.dtype and gs.dtype == torch.float32 and gs.shape == ws.shape
    torch.testing.assert_close(gy.float().cpu(), wy.float().cpu(), rtol=t, atol=t)
    torch.testing.assert_close(gs.cpu(), ws.cpu(), rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("chunk", ssd_kernel.CHUNKS)
def test_ssd_kernel_matches_plain(cuda, dtype, shape, chunk):
    """y and the final state against the plain ``ssd_chunked``."""
    t = _ssd_inputs(("ssd", shape, dtype), *shape, dtype, cuda)
    got = ssd_kernel.ssd(*t, chunk=chunk, return_state=True)
    want = ssd_ref.ssd_chunked(*t, chunk=ssd_ref.align_chunk(64, shape[1]), return_state=True)
    _ssd_close(got, want, dtype)


# (b, s, h, p, n, g): S = 2 (one short chunk) and S = 300 (a ragged last
# chunk) at head counts that ssd_tc's head block of 4 does not divide (25, 7)
# and does (48); the batches are large enough that the launch takes that head
# block at both chunks on a 132-SM card, so the last block of each group is ragged
SSD_EDGE_SHAPES = [
    (20, 2, 25, 128, 16, 1),
    (8, 300, 25, 128, 16, 1),
    (66, 2, 7, 32, 128, 1),
    (16, 300, 7, 32, 128, 1),
    (1, 2, 48, 64, 128, 1),
    (1, 300, 48, 64, 128, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SSD_EDGE_SHAPES)
@pytest.mark.parametrize("chunk", ssd_kernel.CHUNKS)
def test_ssd_kernel_short_ragged_and_a_ragged_head_block(cuda, dtype, shape, chunk):
    t = _ssd_inputs(("edge", shape, dtype), *shape, dtype, cuda)
    got = ssd_kernel.ssd(*t, chunk=chunk, return_state=True)
    want = ssd_ref.ssd_chunked(*t, chunk=ssd_ref.align_chunk(64, shape[1]), return_state=True)
    _ssd_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_wrapper_sends_each_dtype_to_its_own_library(cuda, dtype, monkeypatch):
    """bfloat16 launches ssd_tc, float32 ssd; each library refuses the other
    dtype (cudaErrorInvalidValue, nothing launched): neither is a fallback."""
    t = _ssd_inputs(("route", dtype), 1, 100, 8, 64, 128, 1, dtype, cuda)
    used, real = [], ssd_kernel._entry
    monkeypatch.setattr(ssd_kernel, "_entry", lambda source: used.append(source) or real(source))
    got = ssd_kernel.ssd(*t, return_state=True)
    assert used == [{"bfloat16": "ssd_tc", "float32": "ssd"}[dtype]]
    _ssd_close(got, ssd_ref.ssd_chunked(*t, chunk=50, return_state=True), dtype)
    other = "ssd" if used[0] == "ssd_tc" else "ssd_tc"
    code = {"bfloat16": 1, "float32": 0}[dtype]
    n_ptr = {"ssd": 8, "ssd_tc": 11}[other]
    tail = [code, 1, 100, 8, 64, 1, 128, 64] + ([32] if other == "ssd" else [])
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert real(other)(*([None] * n_ptr), *tail, stream) == 1   # cudaErrorInvalidValue


@pytest.mark.cuda
def test_ssd_tc_call_adds_one_launch(cuda):
    """ssd_tc launches three CUDA kernels a call; ``ssd.launches`` counts the
    call once, so a prefill adds one per layer."""
    t = _ssd_inputs("count", 1, 300, 25, 128, 16, 1, "bfloat16", cuda)
    before = ssd_kernel.ssd.launches
    got = ssd_kernel.ssd(*t, chunk=64, return_state=True)
    assert ssd_kernel.ssd.launches == before + 1
    _ssd_close(got, ssd_ref.ssd_chunked(*t, chunk=4, return_state=True), "bfloat16")


@pytest.mark.cuda
def test_ssd_kernel_without_d_or_state(cuda):
    t = _ssd_inputs("no_d", 1, 100, 4, 32, 128, 1, "float32", cuda)
    got = ssd_kernel.ssd(*t[:5])
    want = ssd_ref.ssd_chunked(*t[:5], chunk=50)
    _ssd_close((got, torch.zeros(1)), (want, torch.zeros(1)), "float32")


@pytest.mark.cuda
def test_ssd_kernel_stays_finite_under_a_steep_decay(cuda):
    """exp(cs_i - cs_j) overflows above the diagonal when A·dt is large: the
    kernel never evaluates it there."""
    t = _ssd_inputs("steep", 1, 128, 4, 32, 16, 1, "float32", cuda)
    t[2] = torch.full_like(t[2], -60.0)
    y, s = ssd_kernel.ssd(*t, return_state=True)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _ssd_close((y, s), ssd_ref.ssd_chunked(*t, chunk=64, return_state=True), "float32")


@pytest.mark.cuda
def test_ssd_ops_dispatch_launches_the_kernel_and_counts(cuda):
    t = _ssd_inputs("ssd_ops", 1, 96, 8, 64, 128, 1, "bfloat16", cuda)
    before = ssd_kernel.ssd.launches
    got = ssd_ops.ssd(*t, return_state=True)
    assert ssd_kernel.ssd.launches == before + 1
    _ssd_close(got, ssd_ref.ssd_chunked(*t, chunk=32, return_state=True), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float16", "state_dim", "head_dim", "strided", "groups",
                                 "dt_dtype", "chunk", "init_state", "tc_head_dim", "unaligned"])
def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(cuda, bad):
    x, dt, A, B, C, D = _ssd_inputs("ssd_bad", 1, 16, 4, 32, 16, 2, "bfloat16", cuda)
    kw = {}
    if bad == "float16":
        x, B, C = x.half(), B.half(), C.half()
    elif bad == "state_dim":
        B, C = B[..., :8].contiguous(), C[..., :8].contiguous()
    elif bad == "head_dim":
        x = x[..., :24].contiguous()
    elif bad == "strided":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "groups":
        x, dt, A, D = x[:, :, :3].contiguous(), dt[..., :3].contiguous(), A[:3], D[:3]
    elif bad == "dt_dtype":
        dt = dt.to(torch.bfloat16)
    elif bad == "chunk":
        kw = {"chunk": 128}
    elif bad == "tc_head_dim":    # ssd_tc is compiled for head dims 8, 16, 32, 64, 128
        x = torch.zeros((1, 16, 4, 48), dtype=x.dtype, device=cuda)
    elif bad == "unaligned":      # ssd_tc copies x in 16-byte pieces
        x = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    else:
        kw = {"init_state": torch.ones((1, 4, 32, 16), device=cuda)}
    before = ssd_kernel.ssd.launches
    with pytest.raises(ValueError):
        ssd_kernel.ssd(x, dt, A, B, C, D, **kw)
    assert ssd_kernel.ssd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_does_not_depend_on_the_chunk(cuda, dtype):
    """The two compiled chunks give one result within the kernel's tolerance."""
    t = _ssd_inputs(("chunks", dtype), 1, 300, 48, 64, 128, 1, dtype, cuda)
    y32, s32 = ssd_kernel.ssd(*t, chunk=32, return_state=True)
    y64, s64 = ssd_kernel.ssd(*t, chunk=64, return_state=True)
    _ssd_close((y32, s32), (y64, s64), dtype)


# ----------------------------------------------------------------- rmsnorm
RMS_SHAPES = [
    (8, 128), (2, 16, 256),                      # tests/test_kernels.py's spot checks
    (3, 96), (6, 160), (2, 5, 48), (7, 1024),    # ... and its RMS_GRID
    (8, 1536), (1024, 1536), (16384, 1536),      # mamba2-780m's norm width
    (8, 1600), (1024, 1600), (16384, 1600),      # hymba-1.5b's
]


def _rms_inputs(tag, shape, dtype, device, residual):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, DTYPES[dtype])
    r = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, DTYPES[dtype])
         if residual else None)
    scale = torch.linspace(0.5, 1.5, shape[-1], device=device)
    return x, r, scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, shape, residual):
    x, r, scale = _rms_inputs(("rms", shape, dtype, residual), shape, dtype, cuda, residual)
    got = rms_kernel.rmsnorm(x, scale, r)
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, rms_ref.rmsnorm(x, scale, r), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", rms_kernel.BLOCK_ROWS)
@pytest.mark.parametrize("row_threads", rms_kernel.ROW_THREADS)
@pytest.mark.parametrize("shape", [(37, 1536), (11, 100)])   # ragged last block; scalar path
def test_every_rmsnorm_instance_matches_plain(cuda, block_rows, row_threads, shape):
    x, r, scale = _rms_inputs(("inst", shape), shape, "bfloat16", cuda, True)
    got = rms_kernel.rmsnorm(x, scale, r, block_rows=block_rows, row_threads=row_threads)
    _close(got, rms_ref.rmsnorm(x, scale, r), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", rms_kernel.BLOCK_ROWS)
@pytest.mark.parametrize("row_threads", rms_kernel.ROW_THREADS)
@pytest.mark.parametrize("rows", [2048, 16384])
def test_every_rmsnorm_instance_matches_plain_at_the_grid_shapes(cuda, block_rows, row_threads,
                                                                 rows):
    """The `kernels` campaign grid's RMSNorm cells (bf16, d 1536, no
    residual) time every instance and may promote any of them."""
    x, _, scale = _rms_inputs(("grid", rows), (rows, 1536), "bfloat16", cuda, False)
    got = rms_kernel.rmsnorm(x, scale, block_rows=block_rows, row_threads=row_threads)
    _close(got, rms_ref.rmsnorm(x, scale), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_rmsnorm_kernel_reads_any_float_scale(cuda, scale_dtype):
    x, _, scale = _rms_inputs("scale", (64, 1536), "bfloat16", cuda, False)
    scale = scale.to(scale_dtype)
    _close(rms_kernel.rmsnorm(x, scale), rms_ref.rmsnorm(x, scale), "bfloat16")


@pytest.mark.cuda
def test_rmsnorm_ops_dispatch_launches_the_kernel_and_counts(cuda):
    x, _, scale = _rms_inputs("rms_ops", (2048, 1536), "bfloat16", cuda, False)
    before = rms_kernel.rmsnorm.launches
    got = rms_ops.rmsnorm(x, scale)
    assert rms_kernel.rmsnorm.launches == before + 1
    _close(got, rms_ref.rmsnorm(x, scale), "bfloat16")
    plain = rms_ops.rmsnorm(x, scale, impl="plain")
    assert rms_kernel.rmsnorm.launches == before + 1
    _close(plain, rms_ref.rmsnorm(x, scale), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float16", "mixed", "scale_dtype", "scale_shape", "residual_shape",
                                 "strided", "block_rows", "row_threads", "device"])
def test_rmsnorm_wrapper_refuses_what_the_kernel_does_not_take(cuda, bad):
    x, r, scale = _rms_inputs("rms_bad", (16, 256), "bfloat16", cuda, True)
    kw = {}
    if bad == "float16":
        x, r = x.half(), r.half()
    elif bad == "mixed":
        r = r.float()
    elif bad == "scale_dtype":
        scale = scale.double()
    elif bad == "scale_shape":
        scale = scale[:128]
    elif bad == "residual_shape":
        r = r[:8]
    elif bad == "strided":
        x = x.t().contiguous().t()
    elif bad == "block_rows":
        kw = {"block_rows": 3}
    elif bad == "row_threads":
        kw = {"row_threads": 512}
    else:
        scale = scale.cpu()
    before = rms_kernel.rmsnorm.launches
    with pytest.raises(ValueError):
        rms_kernel.rmsnorm(x, scale, r, **kw)
    assert rms_kernel.rmsnorm.launches == before


# -------------------------------------------------- captured programs (graphs)
# The server's steps as CUDA graphs against the same bodies run eagerly
# (repro_torch.core.compilecache, repro_torch.runtime.serve_loop): the same
# kernels run in the same order on the same buffers, so outputs and token
# streams are identical, not merely close.
GRAPH_MODELS = ["olmo-1b", "mamba2-780m", "hymba-1.5b", "olmoe-1b-7b", "mixtral-8x22b",
                "seamless-m4t-medium", "llama-3.2-vision-11b"]


def _reduced(name, dtype, device, seed=5):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(name).reduced().validate()
    gen = torch.Generator(device=device).manual_seed(seed)
    return M.init_params(cfg, gen, device=device, dtype=DTYPES[dtype]), cfg


def _graph_prompts(tag, n):
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    return [rng.integers(2, 250, size=int(k)).astype(np.int32) for k in rng.integers(1, 30, n)]


def _launch_counts():
    return {"flash_attention": kernel.flash_attention.launches, "ssd": ssd_kernel.ssd.launches,
            "rmsnorm": rms_kernel.rmsnorm.launches}


def _serve_on(params, cfg, device, step, mode, prompts, **settings):
    from repro_torch.runtime.serve_loop import BatchedServer

    srv = BatchedServer(params, cfg, capacity=64, eos_id=-1, mode=mode, device=device,
                        step=step, settings=settings)
    n0 = _launch_counts()
    for p in prompts:
        srv.submit(p)
    srv.run(max_new_tokens=10)
    torch.cuda.synchronize()
    launches = {k: v - n0[k] for k, v in _launch_counts().items()}
    return srv, {r.rid: list(r.tokens) for r in srv.results.values()}, launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPH_MODELS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["continuous", "gang"])
def test_graph_server_serves_the_eager_streams_and_counts_exactly(cuda, name, dtype, mode):
    """Graph and eager paths give identical streams; under replay each
    kernel's launches are (prefills + prefill captures) x layers."""
    params, cfg = _reduced(name, dtype, cuda)
    prompts = _graph_prompts((name, dtype, mode), 7)
    settings = {"max_batch": 3, "sync_interval": 4} if mode == "continuous" else {"max_batch": 3}
    eager, want, eager_launches = _serve_on(params, cfg, cuda, "eager", mode, prompts, **settings)
    graph, got, graph_launches = _serve_on(params, cfg, cuda, "graph", mode, prompts, **settings)
    assert got == want
    # launches a prefill: one per attention call (an encoder-decoder's
    # encoder layers and its decoder's self and cross; a VLM's layers and
    # its groups' cross blocks) and one SSD scan a layer
    attn = {"encdec": cfg.enc_layers + 2 * cfg.n_layers,
            "vlm": cfg.n_layers + cfg.n_layers // max(cfg.cross_attn_period, 1)}.get(
                cfg.family, cfg.n_layers if cfg.family in ("dense", "moe", "hybrid") else 0)
    per_prefill = {"flash_attention": attn,
                   "ssd": cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0, "rmsnorm": 0}
    captures = graph.prefill_captures
    assert captures == len(graph._admit_steps) and graph.prefill_calls == eager.prefill_calls
    for k, n in per_prefill.items():
        assert eager_launches[k] == eager.prefill_calls * n, k
        assert graph_launches[k] == (graph.prefill_calls + captures) * n, k
    assert graph.graphs.replays["serve.decode_fused" if mode == "continuous"
                                else "serve.decode_step"] == graph.decode_steps - 1


@pytest.mark.cuda
def test_two_live_graph_servers_keep_their_own_graphs(cuda):
    """Interleaved on one card, two graph servers with one context: the
    registry's steps are shared, the graphs and buffers are not."""
    params, cfg = _reduced("olmo-1b", "bfloat16", cuda)
    prompts = _graph_prompts("two-servers", 6)
    _, want, _ = _serve_on(params, cfg, cuda, "eager", "continuous", prompts, max_batch=2)
    from repro_torch.runtime.serve_loop import BatchedServer

    a, b = (BatchedServer(params, cfg, capacity=64, eos_id=-1, device=cuda, step="graph",
                          settings={"max_batch": 2}) for _ in range(2))
    assert a._fused_step is b._fused_step
    for p in prompts:
        a.submit(p)
        b.submit(p)
    a.begin_run(10)
    b.begin_run(10)
    while a.queue or a.live_slots or b.queue or b.live_slots:
        for srv in (a, b):
            if srv.queue or srv.live_slots:
                srv.step()
    for srv in (a, b):
        assert {r.rid: list(r.tokens) for r in srv.results.values()} == want
    ga = {s.graph for s in a.graphs.bound.values()}
    assert ga.isdisjoint({s.graph for s in b.graphs.bound.values()})


@pytest.mark.cuda
def test_kernels_replay_in_a_graph_as_they_run_eagerly(cuda):
    """The three kernels captured on static buffers, replayed on new data
    copied into them: bit-identical to eager calls, one launch a kernel a
    replay added to each wrapper's count."""
    from repro_torch.core.compilecache import Graphs

    q, k, v = _qkv("graph-attn", 2, 160, 160, 4, 2, 64, "bfloat16", cuda)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 96, 8, 64)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    dt = torch.rand((2, 96, 8), device=cuda) * 0.1
    A = -torch.rand((8,), device=cuda)
    B, C = (torch.randn((2, 96, 1, 128), device=cuda).to(torch.bfloat16) / 128 ** 0.25
            for _ in range(2))
    r = torch.randn((64, 1536), device=cuda).to(torch.bfloat16)
    scale = torch.ones(1536, device=cuda)
    outs = {"attn": torch.empty_like(q), "y": torch.empty_like(x),
            "state": torch.empty((2, 8, 64, 128), device=cuda), "norm": torch.empty_like(r)}

    def body(q, k, v, x, dt, A, B, C, r, scale, outs):
        outs["attn"].copy_(kernel.flash_attention(q, k, v, causal=True))
        y, state = ssd_kernel.ssd(x, dt, A, B, C, return_state=True)
        outs["y"].copy_(y)
        outs["state"].copy_(state)
        outs["norm"].copy_(rms_kernel.rmsnorm(r, scale))

    inputs = (q, k, v, x, dt, A, B, C, r, scale)
    step = Graphs(capture=True).bind("t.kernels", body, *inputs, outs)
    step()                                                   # warm-up + capture
    for t in inputs:                                         # new data, same buffers
        if t.is_floating_point() and t is not A:
            t.mul_(0.5)
    n0 = _launch_counts()
    step()
    torch.cuda.synchronize()
    assert {k_: v_ - n0[k_] for k_, v_ in _launch_counts().items()} == {
        "flash_attention": 1, "ssd": 1, "rmsnorm": 1}
    got = {k_: v_.clone() for k_, v_ in outs.items()}
    body(*inputs, outs)
    torch.cuda.synchronize()
    for k_ in outs:
        assert torch.equal(got[k_], outs[k_]), k_


@pytest.mark.cuda
def test_a_promotion_reaches_only_graphs_captured_after_it(cuda, tmp_path):
    """Settings resolve at capture: an existing graph keeps the kernel it
    captured after an override sends the workload to the plain version; a
    graph captured after the override runs the plain version."""
    from repro_torch.core import configstore
    from repro_torch.core.compilecache import Graphs

    q, k, v = _qkv("graph-settings", 1, 128, 128, 4, 4, 64, "bfloat16", cuda)
    out = torch.empty_like(q)
    wl = ops.workload_signature(1, 128, 128, 64)

    def body(q, k, v, out):
        out.copy_(ops.flash_attention(q, k, v, causal=True))

    store = configstore.ConfigStore(tmp_path / "store")
    old = configstore.set_default_store(store)
    try:
        before = Graphs(capture=True).bind("t.settings", body, q, k, v, out)
        before()
        store.set_override("torch_flash_attention", wl, {"impl": "naive"})
        n0 = kernel.flash_attention.launches
        before()
        assert kernel.flash_attention.launches == n0 + 1 and before.deltas[0] == 1
        after = Graphs(capture=True).bind("t.settings", body, q, k, v, torch.empty_like(q))
        after()
        after()
        assert kernel.flash_attention.launches == n0 + 1 and after.deltas[0] == 0
    finally:
        configstore.set_default_store(old)


@pytest.mark.cuda
def test_a_graph_server_frees_its_graphs_and_buffers(cuda):
    """A freed graph server's graphs and buffers go to the next server of
    its params and context, which allocates nothing new for them; dropping
    what was handed over frees them all."""
    import gc

    from repro_torch.core import compilecache

    params, cfg = _reduced("olmo-1b", "bfloat16", cuda)
    prompts = _graph_prompts("free", 5)

    def settle():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    # a first server sets up what the process keeps (the capture stream's
    # cuBLAS workspace, the built kernels); a second must leave nothing
    _serve_on(params, cfg, cuda, "graph", "continuous", prompts, max_batch=2)
    compilecache.drop_handed_over()
    base = settle()
    srv, _, _ = _serve_on(params, cfg, cuda, "graph", "continuous", prompts, max_batch=2)
    assert torch.cuda.memory_allocated() > base
    del srv
    held = settle()
    assert held > base                               # handed over, not freed
    srv, _, _ = _serve_on(params, cfg, cuda, "graph", "continuous", prompts, max_batch=2)
    assert srv.prefill_captures == 0 and settle() <= held
    del srv
    compilecache.drop_handed_over()
    assert settle() <= base


# ------------------------------------------------------------ the GP engine
def _engine_history(seed: int, n: int, device, fit_hypers: bool):
    from repro_torch.bench.optimizer_throughput import with_history
    return with_history("torch", seed, n, device, fit_hypers=fit_hypers)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_gp_engine_on_the_card_suggests_the_cpus_configs(cuda, seed):
    """float64 on the card: three asks at fixed hypers equal the same
    engine's on the CPU; suggest and append run as replays of programs
    captured once per shape class, the factor as a program shared by the
    engines of its class."""
    from repro_torch.bench.optimizer_throughput import objective
    from repro_torch.core.optimizers import engine as te

    a = _engine_history(seed, 25, cuda, fit_hypers=False)
    b = _engine_history(seed, 25, "cpu", fit_hypers=False)
    for _ in range(3):
        ca, cb = a.ask(), b.ask()
        assert ca == cb
        a.tell(ca, objective(ca))
        b.tell(cb, objective(cb))
    a.ask()
    graphs = a._engine.graphs
    assert graphs.captures == {"gp.append": 1, "gp.suggest": 1}
    assert graphs.replays["gp.suggest"] == 3 and graphs.replays["gp.append"] == 2
    factor = [step for (key, variant, _), step in te._SHARED_GRAPHS[a._engine.device].bound.items()
              if key == "gp.full_chol" and variant == ("matern32", 6, 32)]
    assert len(factor) == 1 and factor[0].graph is not None


@pytest.mark.cuda
def test_the_gp_engine_fit_and_batched_ask_on_the_card(cuda):
    """The fitted θ on the card within 1e-8 of the CPU's, and the batched ask
    of 8 sessions equal to 8 sequential asks."""
    from repro_torch.core.optimizers.engine import batched_ask

    on_card, on_cpu = (_engine_history(1, 40, dev, fit_hypers=True) for dev in (cuda, "cpu"))
    on_card.ask()
    on_cpu.ask()
    np.testing.assert_allclose(on_card._engine.theta, on_cpu._engine.theta, rtol=1e-8)
    seq = [_engine_history(7 + s, 25, cuda, fit_hypers=True) for s in range(8)]
    bat = [_engine_history(7 + s, 25, cuda, fit_hypers=True) for s in range(8)]
    assert [o.ask() for o in seq] == batched_ask(bat)


# --------------------------------------------------------------------- MoE
def _qk_normed(t):
    """Unit-rms rows per head, as OLMoE's QK-norm gives the kernel."""
    f = t.float()
    return (f * torch.rsqrt(f.square().mean(-1, keepdim=True) + 1e-6)).to(t.dtype)


def _plain_by_rows(q, k, v, window, rows=2048):
    """``naive_attention`` a block of query rows at a time (the float32
    scores of an 8192-token prefill at 48 heads would take 13 GB at once)."""
    return torch.cat([ref.naive_attention(q[:, r0:r0 + rows], k, v, causal=True, window=window,
                                          q_offset=r0) for r0 in range(0, q.shape[1], rows)], 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [("olmoe-1b-7b", 1024, 16, 16, 0),
                                  ("mixtral-8x22b", 8192, 48, 8, 4096)], ids=lambda c: c[0])
def test_kernel_matches_plain_at_the_moe_prefill_shapes(cuda, dtype, case):
    """OLMoE's widest prefill (S1024 H16 K16 D128, QK-normed q and k) and
    Mixtral's past its window (S8192 H48 K8 D128, window 4096)."""
    name, s, h, kh, window = case
    q, k, v = _qkv(("moe", name, dtype), 1, s, s, h, kh, 128, dtype, cuda)
    if name == "olmoe-1b-7b":
        q, k = _qk_normed(q), _qk_normed(k)
    got = kernel.flash_attention(q, k, v, causal=True, window=window)
    _close(got, _plain_by_rows(q, k, v, window), dtype)


def _moe_config(name, layers):
    from repro_torch.configs import get_config

    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, n_layers=layers) if layers else cfg.reduced()
    return dataclasses.replace(cfg, dtype="bfloat16").validate()


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("name,layers", [("olmoe-1b-7b", 2), ("mixtral-8x22b", None)])
def test_moe_decode_step_on_a_graph_equals_eager_bit_for_bit(cuda, name, layers):
    """A decode step of 8 slots at their own positions, bf16: OLMoE at full
    width (2 of its layers) and reduced Mixtral (its 16-slot ring wraps),
    captured as a CUDA graph and replayed, against the same step run
    eagerly on a copy of the same state: the same logits and caches, bit
    for bit (routing, capacity and combine read nothing back to the host)."""
    from repro_torch.models import model as M

    cfg = _moe_config(name, layers)
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    rng = np.random.default_rng(zlib.crc32(repr(("moe-graph", name)).encode()))
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (8, 32))).to(cuda)
    _, caches, _ = M.prefill(params, cfg, toks, 64)
    tok = torch.from_numpy(rng.integers(2, cfg.vocab_size, (8,))).to(cuda)
    pos = torch.tensor([32, 5, 17, 32, 1, 9, 40, 30], device=cuda)
    eager, graph = _clone(caches), _clone(caches)
    want, _ = M.decode_step(params, cfg, tok, eager, pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up: rewrites the same K/V rows
        M.decode_step(params, cfg, tok, graph, pos)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got, _ = M.decode_step(params, cfg, tok, graph, pos)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for a, b in zip(graph, eager):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


@pytest.mark.cuda
def test_a_moe_train_step_gives_the_same_bits_twice(cuda):
    """One train step of full-width OLMoE-1B-7B cut to one layer (batch 2 x
    512), twice from the same seeded state: the same metrics and the same
    parameters and moments, bit for bit (the capacity dispatch's gradients
    add with no float atomics)."""
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.tree import leaves_with_paths

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = _moe_config("olmoe-1b-7b", 1)
    rng = np.random.default_rng(zlib.crc32(b"moe-train"))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512))).to(cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    step = make_train_step(cfg)
    runs = []
    for _ in range(2):
        state = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
        state, metrics = step(state, batch)
        runs.append((state, {k: float(v) for k, v in metrics.items()}))
        torch.cuda.synchronize()
    (a, ma), (b, mb) = runs
    assert ma == mb and ma["aux"] > 0
    for (path, x), (_, y) in zip(leaves_with_paths(a), leaves_with_paths(b)):
        assert torch.equal(x, y), path
