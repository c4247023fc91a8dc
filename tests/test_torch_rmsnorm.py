"""The port's RMSNorm (``repro_torch.kernels.rmsnorm``) against the
reference's: the plain ``ref.rmsnorm`` against ``repro``'s ``ref.rmsnorm``
and against the Pallas kernel ``rmsnorm_pallas`` in interpret mode, on
``tests/test_kernels.py``'s shapes and the served widths, in float32 and
bfloat16, with and without the residual; the ``torch_rmsnorm_kernel``
component's CPU routing and workload signature.

Inputs are drawn with numpy from ``zlib.crc32`` seeds and handed to both
packages.  Tolerances (absolute and relative) are tests/test_kernels.py's
``_grid_tol``: float32 170·eps (summation order), bfloat16 5·2⁻⁸ (inputs
and output rounded, f32 accumulation).  The Hopper kernel itself runs only
on the card (``tests/test_torch_kernel_card.py``).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import ops as jops
from repro.kernels.rmsnorm import ref as jref
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro_torch.kernels.rmsnorm import kernel as tkernel
from repro_torch.kernels.rmsnorm import ops as tops
from repro_torch.kernels.rmsnorm import ref as tref

SHAPES = [
    (8, 128), (2, 16, 256),                      # tests/test_kernels.py's spot checks
    (3, 96), (6, 160), (2, 5, 48), (7, 1024),    # ... and its RMS_GRID
    (8, 1536), (8, 1600),                        # mamba2-780m's and hymba-1.5b's norm widths
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str) -> dict:
    t = 5.0 * 2.0 ** -8 if dtype == "bfloat16" else 170.0 * float(np.finfo(np.float32).eps)
    return dict(rtol=t, atol=t)


def _draw(shape, dtype, residual):
    """(jax args, torch args) of x, scale, residual from one crc32 seed; x and
    the residual rounded to ``dtype`` the same way in both packages."""
    rng = np.random.default_rng(zlib.crc32(repr(("rms", shape, dtype, residual)).encode()))
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32) if residual else None
    scale = np.linspace(0.5, 1.5, shape[-1], dtype=np.float32)
    jd, td = DTYPES[dtype]
    j = (jnp.asarray(x).astype(jd), jnp.asarray(scale),
         jnp.asarray(r).astype(jd) if residual else None)
    t = (torch.from_numpy(x).to(td), torch.from_numpy(scale),
         torch.from_numpy(r).to(td) if residual else None)
    return j, t


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
def test_plain_rmsnorm_matches_reference(dtype, shape, residual):
    j, t = _draw(shape, dtype, residual)
    got = tref.rmsnorm(t[0], t[1], t[2])
    assert got.dtype == t[0].dtype and tuple(got.shape) == shape
    np.testing.assert_allclose(_np(got), _np(jref.rmsnorm(*j)), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
def test_kernel_route_on_cpu_matches_the_pallas_kernel(dtype, shape, residual):
    """The kernel wrapper's CPU route (the plain version) against the TPU
    kernel run in interpret mode, as tests/test_kernels.py runs it."""
    j, t = _draw(shape, dtype, residual)
    want = rmsnorm_pallas(j[0], j[1], j[2], block_rows=4, interpret=True)
    before = tkernel.rmsnorm.launches
    got = tkernel.rmsnorm(t[0], t[1], t[2], block_rows=16, row_threads=32)
    assert tkernel.rmsnorm.launches == before      # a CPU tensor reaches no kernel
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("impl", ["kernel", "plain", None])
def test_ops_on_a_cpu_tensor_route_to_the_plain_version(impl):
    _, (x, scale, r) = _draw((6, 160), "bfloat16", True)
    before = tkernel.rmsnorm.launches
    got = tops.rmsnorm(x, scale, r, impl=impl)
    assert tkernel.rmsnorm.launches == before
    torch.testing.assert_close(got, tref.rmsnorm(x, scale, r), rtol=0, atol=0)


def test_ops_refuses_an_unknown_impl():
    _, (x, scale, _) = _draw((3, 96), "float32", False)
    with pytest.raises(ValueError):
        tops.rmsnorm(x, scale, impl="pallas")


@pytest.mark.parametrize("rows,d", [(1, 8), (3, 96), (2048, 1536), (2000, 1536), (16384, 1536),
                                    (16385, 1600)])
def test_workload_signature_matches_reference(rows, d):
    assert tops.workload_signature(rows, d) == jops.workload_signature(rows, d)


def test_component_declares_the_kernel_launch_space():
    meta = tops.rmsnorm_settings.mlos_meta
    assert meta.name == "torch_rmsnorm_kernel"
    assert meta.space["impl"].choices == ("plain", "kernel") and meta.space["impl"].default == "kernel"
    assert meta.space["block_rows"].choices == tkernel.BLOCK_ROWS
    assert meta.space["row_threads"].choices == tkernel.ROW_THREADS
    assert [m.name for m in meta.metrics] == [m.name for m in jops.rmsnorm_settings.mlos_meta.metrics]
