"""Hopper SSD chunked scan: the wrapper of the two CUDA sources.

The port of ``repro/kernels/ssd/kernel.py:ssd_pallas``.  The dispatch is by
dtype, here and nowhere else:

  * bfloat16 → ``csrc/ssd_tc.cu``: three launches (chunk states, state
    passing, chunk scan), every chunk in parallel, the products on the
    tensor cores (``mma.sync``);
  * float32 → ``csrc/ssd.cu``: one block walks the chunks with exact f32
    FMAs, because the float32 checks (4·170·eps on the card, the reduced
    models against the CPU) need full f32 products that TF32 or bf16
    tensor cores would break.

Neither is a fallback for the other: each library takes only its dtype.
The CUDA sources say what bounds each kernel and how it is laid out; this
module checks what the kernel takes, allocates y, the final state and the
tensor-core kernel's scratch and launches it on PyTorch's current stream
through a ``ctypes`` binding of the library that
:mod:`repro_torch.kernels.build` compiles at first use.

A CPU tensor goes to the plain version, :func:`ref.ssd_chunked`; that is
the only route to it.  A CUDA tensor launches a kernel or raises.  Unlike
the Pallas kernel, these write the final state they carry (the Pallas
wrapper recomputes it with the plain version).  ``ssd.launches`` counts
wrapper calls that launched (one per call, however many passes), so a run
can show that its prefill (or train step) went through the kernels.

Gradients.  The TPU kernel has no backward kernel (the reference
differentiates its jnp path), so neither does this one.  A CUDA input that
requires grad goes through :class:`SsdFn`: the forward is the kernel, and
the backward recomputes :func:`ref.ssd_chunked` on the saved inputs with
autograd and backpropagates through it — the gradient ``jax.grad`` gives
over the reference's plain path.  An ``init_state`` that requires grad
raises: the kernel takes none, and no path differentiates through one.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import build
from . import ref

__all__ = ["ssd", "SsdFn", "CHUNKS", "STATE_DIMS", "SOURCES", "TC_HEAD_DIMS"]

CHUNKS = (32, 64)              # compiled chunk lengths
STATE_DIMS = (16, 128)         # the state sizes of hymba-1.5b and mamba2-780m
SOURCES = {torch.float32: "ssd", torch.bfloat16: "ssd_tc"}
TC_HEAD_DIMS = (16, 32, 64, 128)   # the head dims ssd_tc's scan pass is compiled for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# tensor arguments before the ints, per source: ssd_tc adds its three scratch buffers
_POINTERS = {"ssd": 8, "ssd_tc": 11}
_INTS = {"ssd": 9, "ssd_tc": 8}


@functools.lru_cache(maxsize=None)
def _entry(source: str):
    fn = getattr(build.load(source), f"repro_{source}_fwd")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * _POINTERS[source] + [ctypes.c_int] * _INTS[source]
                   + [ctypes.c_void_p])
    return fn


def _p_slice(head_dim: int) -> int:
    """Head-dim columns per CUDA block (the kernel's P split)."""
    return 32 if head_dim % 32 == 0 else 16


def _check(x, dt, A, B, C, D, chunk: int) -> None:
    tensors = {"x": x, "dt": dt, "A": A, "B": B, "C": C}
    if D is not None:
        tensors["D"] = D
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors.values()):
        raise ValueError("ssd kernel needs every tensor on one CUDA device; got "
                         + ", ".join(f"{k} {t.device}" for k, t in tensors.items()))
    if x.dtype not in SOURCES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd kernel takes float32 or bfloat16 x, B, C of one dtype; got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    for k in ("dt", "A", "D"):
        if k in tensors and tensors[k].dtype != torch.float32:
            raise ValueError(f"ssd kernel takes float32 {k}; got {tensors[k].dtype}")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"expected x (B,S,H,P) and B, C (B,S,G,N); got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) or \
            (D is not None and tuple(D.shape) != (h,)):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}"
                         + (f", D {tuple(D.shape)}" if D is not None else "")
                         + f" do not fit x {tuple(x.shape)}")
    if B.shape[:2] != x.shape[:2] or g == 0 or h % g:
        raise ValueError(f"B {tuple(B.shape)} does not fit x {tuple(x.shape)} (H % G must be 0)")
    if n not in STATE_DIMS:
        raise ValueError(f"state dim {n} not in {STATE_DIMS}")
    if p == 0 or p % 16:
        raise ValueError(f"head_dim {p} is not a multiple of 16")
    if x.dtype == torch.bfloat16 and p not in TC_HEAD_DIMS:
        raise ValueError(f"head_dim {p} not in {TC_HEAD_DIMS}: ssd_tc is not compiled for it")
    if s == 0 or b == 0:
        raise ValueError("empty batch or sequence")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk={chunk}: compiled chunks are {CHUNKS}")
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{k} must be contiguous")
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_tc copies x, B and C in 16-byte pieces: they must be 16-byte aligned")


def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, D: Optional[torch.Tensor], chunk: int, return_state: bool):
    """Allocate y, the state and the scratch, and launch the dtype's kernel
    (checked inputs).  Returns (y, state or None)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    state = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
             if return_state else None)
    source = SOURCES[x.dtype]
    args = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr() if D is not None else None, y.data_ptr(),
            state.data_ptr() if state is not None else None]
    if source == "ssd_tc":
        # the passes' scratch, one allocation: the chunk states (f32), the
        # state entering each chunk (bf16) and each chunk's decay (f32)
        n_states = b * -(-s // chunk) * h            # one P x N state a (b, chunk, head)
        elems = n_states * p * n
        scratch = torch.empty(6 * elems + 4 * n_states, dtype=torch.uint8, device=x.device)
        base = scratch.data_ptr()
        args += [base, base + 4 * elems, base + 6 * elems]
    args += [_DTYPE_CODE[x.dtype], b, s, h, p, g, n, chunk]
    if source == "ssd":
        args.append(_p_slice(p))
    err = _entry(source)(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel ({source}) launch failed: CUDA error {err}")
    ssd.launches += 1
    return y, state


class SsdFn(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient (see the
    module docstring).  Returns y, or (y, state) with ``return_state``."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk, return_state):
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk, ctx.return_state = chunk, return_state
        y, state = _launch(x, dt, A, B, C, D, chunk, return_state)
        return (y, state) if return_state else y

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) if t is not None else None for t in saved]
            out = ref.ssd_chunked(*ins, chunk=ref.align_chunk(ctx.chunk, saved[0].shape[1]),
                                  return_state=ctx.return_state)
        outs = out if ctx.return_state else (out,)
        live = [t for t in ins if t is not None]
        got = iter(torch.autograd.grad(outs, live, grads, allow_unused=True))
        return (*(next(got) if t is not None else None for t in ins), None, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        D: Optional[torch.Tensor] = None, *, chunk: int = 64,
        init_state: Optional[torch.Tensor] = None, return_state: bool = False):
    """Shapes as :func:`ref.ssd_chunked`; dt, A and D float32.  Returns y
    (B,S,H,P) in x's dtype, and the final state (B,H,P,N) in float32 if
    ``return_state``.  The chunk need not divide S: the kernel masks the
    ragged last chunk.  The kernels start from a zero state: a non-zero
    ``init_state`` raises on the card (no serving path passes one).  Under
    autograd (an input requires grad) the launch goes through
    :class:`SsdFn`."""
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, B, C, D, chunk=ref.align_chunk(chunk, x.shape[1]),
                               init_state=init_state, return_state=return_state)
    _check(x, dt, A, B, C, D, chunk)
    if init_state is not None and (init_state.requires_grad or bool(init_state.any())):
        raise ValueError("the ssd kernel starts from a zero state; a non-zero init_state, "
                         "or one that requires grad, is not taken")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, A, B, C, D)):
        return SsdFn.apply(x, dt, A, B, C, D, chunk, return_state)
    y, state = _launch(x, dt, A, B, C, D, chunk, return_state)
    return (y, state) if return_state else y


ssd.launches = 0
