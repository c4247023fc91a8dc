"""The flash-attention kernels' compiled instances, read on the CPU.

``kernel.smem_bytes`` and ``kernel.compiled`` say, for every (dtype,
block_q, block_kv, head_dim), how much dynamic shared memory the instance
takes and whether its source compiles it; the wrapper refuses the others
before it touches a library.  The card checks that the sources agree with
the table (chip_smoke.py, tests/test_torch_kernel_card.py).
"""
import itertools

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel, ops

DTYPES = [torch.bfloat16, torch.float32]
INSTANCES = list(itertools.product(DTYPES, kernel.TILES, kernel.TILES, kernel.HEAD_DIMS))


def _name(case):
    dtype, bq, bk, d = case
    return f"{str(dtype).replace('torch.', '')}-{bq}x{bk}-d{d}"


@pytest.mark.parametrize("case", INSTANCES, ids=_name)
def test_every_compiled_instance_fits_a_block(case):
    """Compiled iff its shared memory fits the 227 KB a block may use."""
    assert kernel.SMEM_LIMIT == 227 * 1024
    fits = kernel.smem_bytes(*case) <= kernel.SMEM_LIMIT
    assert kernel.compiled(*case) == fits


def test_the_tensor_core_kernel_takes_every_tile_pair():
    """bf16 has no instance the card cannot hold; f32 loses exactly 128/128 at
    head_dim 128 (about 264 KB)."""
    assert all(kernel.compiled(torch.bfloat16, bq, bk, d)
               for bq, bk, d in itertools.product(kernel.TILES, kernel.TILES, kernel.HEAD_DIMS))
    missing = [c[1:] for c in INSTANCES if c[0] == torch.float32 and not kernel.compiled(*c)]
    assert missing == [(128, 128, 128)]
    assert kernel.smem_bytes(torch.float32, 128, 128, 128) == 263680


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda t: str(t).replace("torch.", ""))
@pytest.mark.parametrize("d", kernel.HEAD_DIMS)
def test_the_default_pair_is_compiled_for_both_dtypes(dtype, d):
    space = ops.AttentionKernelSettings.mlos_meta.space
    default = (space["block_q"].default, space["block_kv"].default)
    assert kernel.compiled(dtype, *default, d)
    assert space["block_q"].choices == kernel.TILES == space["block_kv"].choices


@pytest.mark.parametrize("case", [(torch.float32, 128, 128, 128), (torch.bfloat16, 32, 64, 64),
                                  (torch.bfloat16, 64, 256, 128), (torch.float32, 64, 64, 24)],
                         ids=_name)
def test_the_wrapper_refuses_an_uncompiled_instance_before_the_library(monkeypatch, case):
    """Off the CPU, an instance that is not compiled raises a ValueError that
    names the pair, and no library is built, loaded or called."""
    dtype, bq, bk, d = case
    touched = []
    monkeypatch.setattr(kernel.build, "load", lambda name: touched.append(name))
    monkeypatch.setattr(kernel.build, "build", lambda names: touched.append(names))
    q = torch.empty((1, 8, 2, d), device="meta", dtype=dtype)
    before = kernel.flash_attention.launches
    with pytest.raises(ValueError, match=f"block_q={bq}, block_kv={bk}" if d != 24 else "head_dim"):
        kernel.flash_attention(q, q, q, block_q=bq, block_kv=bk)
    assert touched == [] and kernel.flash_attention.launches == before


def test_each_dtype_has_its_own_library():
    """The dispatch is by dtype: bf16 to the tensor-core source, f32 to the
    FMA one, and no other dtype has a library."""
    assert kernel.SOURCES == {torch.float32: "flash_attention",
                              torch.bfloat16: "flash_attention_tc"}
    for name in kernel.SOURCES.values():
        assert (kernel.build.CSRC / f"{name}.cu").exists()
    with pytest.raises(ValueError):
        kernel.smem_bytes(torch.float16, 64, 64, 64)
