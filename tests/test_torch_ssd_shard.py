"""The SSD kernels at hymba-1.5b's head-dim shard, P 8, on the CPU.

On the production meshes (``single``, ``multi``: a model axis of 16)
hymba-1.5b's 25 SSM heads do not divide the model axis, so the sharding
rules split its SSD head dim instead: 128 / 16 = 8 columns a rank.  Both
Hopper kernels are compiled for P 8 (``csrc/ssd_tc.cu``'s scan pass takes
it as one n8 tile, its chunk-state pass stages it as a 16-row tile whose
last 8 rows are zeros; ``csrc/ssd.cu`` takes it as one slice of 8).  Here:

  * ``ref.ssd_passes``, the CPU model of the bf16 kernel's three passes
    with that padded chunk-state layout, at P 8 against the reference's
    ``ssd_chunked`` and its TPU kernel (``ssd_pallas`` in interpret mode),
    within tests/test_torch_ssd_passes.py's tolerances;
  * the kernels' backward (``SsdFn``, recomputing the passes in float32
    at the kernel's chunk) against ``jax.vjp`` and the port's plain
    version at P 8;
  * the wrapper's ``supports``: P 8 for both dtypes, never P 4;
  * a ``meta`` trace of a reduced hymba on a fake (data 2, model 4) mesh
    whose SSM heads do not divide the model axis: its head dim of 32
    splits to 8 and every SSD call counts as ``kernel``, where a head dim
    of 16 splits to 4 and counts as ``no_kernel``;
  * chip_smoke's dryrun-check-sharded path on that reduced hymba: the SSD
    calls a step makes, at P 8, as many as the phase holds the card's
    launches to.
"""
from __future__ import annotations

import dataclasses
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels.ssd import ops as jops
from repro.kernels.ssd import ref as jref
from repro.kernels.ssd.kernel import ssd_pallas
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import kernel as tkernel
from repro_torch.kernels.ssd import ref as tref
from repro_torch.launch import dryrun, shapes
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.mesh import Mesh
from torch_threads import one_thread

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 4.0 * 170.0 * float(np.finfo(np.float32).eps)
BF16_TOL = 4.0 * 5.0 * 2.0 ** -8
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
MESH = Mesh("t", (("data", 2), ("model", 4)))
# (b, s, h, p, n, g) at P 8: hymba's N 16 at a ragged and a whole last chunk,
# and N 128 with two groups
SHARD_SHAPES = [
    (1, 256, 5, 8, 16, 1),
    (2, 200, 5, 8, 16, 1),
    (1, 192, 4, 8, 128, 1),
    (2, 136, 4, 8, 128, 2),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _draw(tag, b, s, h, p, n, g, dtype):
    """x, dt (softplus'd), A (< 0), B, C (variance N^-1/2), D as numpy
    float32; x, B, C rounded to ``dtype``."""
    rng = np.random.default_rng(zlib.crc32(repr(tag).encode()))
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * n ** -0.25).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * n ** -0.25).astype(np.float32)
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


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------------------------------------ the passes
@pytest.mark.parametrize("reference", ["chunked", "pallas"])
@pytest.mark.parametrize("shape", SHARD_SHAPES)
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_passes_at_the_shard_match_the_reference(reference, shape, chunk, dtype):
    """float32 without rounding, or bf16 inputs rounded where ssd_tc rounds:
    y and the float32 state against the reference's plain SSD and its TPU
    kernel, at P 8."""
    j, t = _both(_draw(("shard", shape, dtype), *shape, dtype), dtype)
    ref_chunk = jops._align(64, shape[1])
    if reference == "chunked":
        wy, ws = jref.ssd_chunked(*j, chunk=ref_chunk, return_state=True)
    else:
        wy, ws = ssd_pallas(*j, chunk=ref_chunk, return_state=True, interpret=True)
    bf16 = dtype == "bfloat16"
    gy, gs = tref.ssd_passes(*t, chunk=chunk, kernel_rounding=bf16, return_state=True)
    assert gy.shape == shape[:4] and gs.shape == (shape[0], shape[2], 8, shape[4])
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(gs), _np(ws), **STATE_TOL)


def test_the_padded_rows_of_the_chunk_states_add_nothing():
    """The 8 zero columns that pad x to a 16-row tile: the passes at P 8
    equal the same passes at P 16 on x with 8 zero columns, column for
    column, and those columns' y and state are zero."""
    shape = (1, 130, 3, 8, 16, 1)
    _, t = _both(_draw("pad", *shape, "float32"), "float32")
    wide = [torch.cat([t[0], torch.zeros_like(t[0])], dim=-1), *t[1:]]
    y8, s8 = tref.ssd_passes(*t, chunk=64, return_state=True)
    y16, s16 = tref.ssd_passes(*wide, chunk=64, return_state=True)
    torch.testing.assert_close(y16[..., :8], y8, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(s16[:, :, :8], s8, rtol=1e-6, atol=1e-6)
    assert not y16[..., 8:].any() and not s16[:, :, 8:].any()


# ------------------------------------------------------------ the backward
@pytest.mark.parametrize("reference", ["jax", "plain"])
@pytest.mark.parametrize("shape", SHARD_SHAPES)
@pytest.mark.parametrize("chunk", [32, 64])
def test_the_kernels_backward_at_the_shard_matches_the_references(monkeypatch, reference,
                                                                   shape, chunk):
    """``SsdFn``'s backward (its launch monkeypatched to the float32 passes)
    recomputes the passes at the kernel's chunk, a ragged last chunk
    included: its gradients in x, dt, A, B, C and D at P 8, y's and the
    state's cotangents both drawn, against ``jax.vjp`` of the reference's
    chunked SSD and against autograd through the port's plain version.
    For ``jax`` dt is drawn a tenth as large: the reference masks
    ``exp(li)`` after taking it, so where a chunk's decay passes float32's
    range its gradient in dt and A is NaN (the port's plain version masks
    before the exp)."""
    def launch(x, dt, A, B, C, D, chunk, rs):
        return tref.ssd_passes(x, dt, A, B, C, D, chunk=chunk, return_state=True)

    monkeypatch.setattr(tkernel, "_launch", launch)
    arrays = list(_draw(("grad", shape, chunk), *shape, "float32"))
    if reference == "jax":
        arrays[1] = arrays[1] / 10
    rng = np.random.default_rng(zlib.crc32(repr(("cot", shape, chunk)).encode()))
    b, s, h, p, n, _ = shape
    cot = (rng.standard_normal((b, s, h, p)).astype(np.float32),
           rng.standard_normal((b, h, p, n)).astype(np.float32))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = torch.autograd.grad(tkernel.SsdFn.apply(*ins, chunk, True), ins,
                              [torch.from_numpy(c) for c in cot])
    if reference == "jax":
        _, vjp = jax.vjp(lambda *a: jref.ssd_chunked(*a, chunk=jops._align(64, s),
                                                     return_state=True),
                         *map(jnp.asarray, arrays))
        want = vjp(tuple(map(jnp.asarray, cot)))
    else:
        plain = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        want = torch.autograd.grad(
            tref.ssd_chunked(*plain, chunk=tref.align_chunk(64, s), return_state=True), plain,
            [torch.from_numpy(c) for c in cot])
    for name, g, w in zip("x dt A B C D".split(), got, want):
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=F32_TOL, atol=F32_TOL, err_msg=name)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_the_backward_recompute_dispatches_a_sixth_of_the_chunk_loops_ops():
    """The host, not the card, bounds a train step's SSD backward: the
    recompute's forward and backward through ``ref.ssd_passes`` (every
    chunk at once) dispatch at most a sixth of the ops that autograd
    through ``ref.ssd_chunked`` (a loop over the chunks) does, at 32
    chunks of 64."""
    arrays = _draw("ops", 1, 2048, 1, 8, 16, 1, "float32")
    counts = {}
    for fn in (tref.ssd_chunked, tref.ssd_passes):
        ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        with _CountOps() as mode:
            y, state = fn(*ins, chunk=64, return_state=True)
            torch.autograd.grad((y.sum() + state.sum(),), ins)
        counts[fn.__name__] = mode.n
    assert counts["ssd_passes"] * 6 <= counts["ssd_chunked"], counts


# -------------------------------------------------------------- supports
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", tkernel.STATE_DIMS)
def test_supports_takes_the_shard_and_not_a_head_dim_of_4(dtype, n):
    assert 8 in tkernel.TC_HEAD_DIMS
    assert tkernel.supports((2, 32768, 25, 8), (2, 32768, 1, n), dtype)
    assert not tkernel.supports((2, 32768, 25, 4), (2, 32768, 1, n), dtype)
    assert tkernel._p_slice(8) == 8 and tkernel._p_slice(128) == 32


def test_a_cpu_tensor_at_the_shard_takes_the_plain_version():
    _, t = _both(_draw("cpu", 1, 100, 5, 8, 16, 1, "float32"), "float32")
    y, s = tkernel.ssd(*t, chunk=64, return_state=True)
    wy, ws = tref.ssd_chunked(*t, chunk=tref.align_chunk(64, 100), return_state=True)
    torch.testing.assert_close(y, wy, rtol=0, atol=0)
    torch.testing.assert_close(s, ws, rtol=0, atol=0)


# ------------------------------------------------- the sharded meta trace
def _hymba(ssm_head_dim: int):
    """Reduced hymba whose SSM heads (d_inner 160: 5 of 32, 10 of 16) do not
    divide a model axis of 4, so the rules split the head dim: 32 -> 8,
    16 -> 4."""
    return dataclasses.replace(get_config("hymba-1.5b").reduced(), d_model=80, n_heads=5,
                               n_kv_heads=5, ssm_head_dim=ssm_head_dim)


def _prefill():
    return shapes.Shape("prefill_32k", "prefill", 64, 8)


@pytest.mark.parametrize("head_dim,routes", [(32, {"kernel": 2, "no_kernel": 0}),
                                             (16, {"kernel": 0, "no_kernel": 2})])
def test_the_sharded_record_counts_the_shard_under_kernel(monkeypatch, head_dim, routes):
    monkeypatch.setitem(launch_mesh.MESHES, "t", MESH)
    cfg = _hymba(head_dim)
    assert cfg.ssm_heads % 4 and cfg.n_layers == 2
    rec = dryrun.run_cell("hymba-1.5b", "prefill_32k", "t", cfg=cfg, shape=_prefill())
    assert rec["status"] == "ok", rec.get("error")
    assert rec["counters"]["kernels"]["ssd"] == routes


# ------------------------------------------- chip_smoke's sharded phase
@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
        yield cs
    finally:
        sys.path.remove(str(ROOT))


def test_the_phase_counts_the_steps_ssd_calls_at_the_shard(chip_smoke, monkeypatch):
    """dryrun-check-sharded's path on the CPU: the step calls the SSD as
    often as the phase holds the card's launches to, every call at P 8 (on
    the CPU the wrapper takes the plain version, so calls are counted at
    the wrapper and none at the launch)."""
    monkeypatch.setitem(launch_mesh.MESHES, "t", MESH)
    calls, wrapped = [], tkernel.ssd

    def counting(x, *a, **kw):
        calls.append(tuple(x.shape))
        return wrapped(x, *a, **kw)

    counting.launches = 0
    monkeypatch.setattr(tkernel, "ssd", counting)
    cfg, shape = _hymba(32), _prefill()
    out = chip_smoke.dryrun_sharded_path("cpu", "hymba-1.5b", "prefill_32k", "t", cfg=cfg,
                                         shape=shape)
    rec = out["record"]
    assert rec["counters"]["kernels"]["ssd"]["no_kernel"] == 0
    assert out["launches"]["ssd"] == 0 and out["ssd_calls"] == []
    n = chip_smoke.sharded_ssd_calls(cfg, shape, rec["microbatches"])
    assert n == cfg.n_layers == 2
    # the record's production trace, its two counter passes, then the two steps
    assert len(calls) >= 2 * n and calls[-n:] == calls[-2 * n:-n]
    assert {c for c in calls[-n:]} == {(shape.global_batch // 2, shape.seq_len, 5, 8)}


def test_the_phase_reckons_hymbas_full_size_calls(chip_smoke):
    hy, pre = get_config("hymba-1.5b"), shapes.SHAPES["prefill_32k"]
    assert chip_smoke.sharded_ssd_calls(hy, pre, 1) == 32
    assert chip_smoke.sharded_ssd_calls(hy, shapes.SHAPES["decode_32k"], 1) == 0
    assert chip_smoke.sharded_ssd_calls(get_config("olmo-1b"), pre, 1) == 0
    assert ("hymba-1.5b", "prefill_32k") in chip_smoke.DRYRUN_SHARDED
    assert chip_smoke.SSD_TIMED["hymba-1.5b single shard"] == (2, 32768, 25, 8, 16, 1)
    assert chip_smoke.ssd_case((2, 32768, 25, 8), (2, 32768, 1, 16)) == (2, 32768, 25, 8, 16, 1)
    # the plain attention's row blocks at the cell's local shape stay near 2 GB of scores
    assert chip_smoke._plain_rows(2, 25, 32768) == 256
    assert chip_smoke._plain_rows(2, 1, 32768) == 1024


def test_the_phase_waits_for_the_background_record(chip_smoke, tmp_path):
    """``Background.wait_for``: the record once the command has written it;
    a command that ends without writing it raises."""
    target = tmp_path / "rec.json"
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    writes = chip_smoke.Background(["sh", "-c", f"sleep 1; echo {{}} > {target}"],
                                   tmp_path / "a", timeout=60.0)
    ends = chip_smoke.Background(["sh", "-c", "true"], tmp_path / "b", timeout=60.0)
    try:
        assert writes.wait_for(target, "t") >= 0 and target.read_text().strip() == "{}"
        with pytest.raises(AssertionError):
            ends.wait_for(tmp_path / "never.json", "t")
    finally:
        writes.stop()
        ends.stop()
