"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality) primitive.

The port of ``repro/kernels/ssd/ref.py``.  The recurrence, per head h,
head-dim p and state-dim n:

    h_t = exp(A * dt_t) * h_{t-1} + dt_t * B_t ⊗ x_t       (state: p × n)
    y_t = C_t · h_t + D * x_t

  * :func:`ssd_naive_scan`  — a loop over time; the exact oracle (small S).
  * :func:`ssd_chunked`     — the block decomposition (Mamba-2 paper §6): a
    quadratic intra-chunk term plus an inter-chunk state recurrence.  The
    model's plain path and the plain version of the Hopper kernel
    (``kernel.py``).
  * :func:`ssd_passes`      — the same function through the bf16 Hopper
    kernel's three passes (``csrc/ssd_tc.cu``): chunk states, state passing,
    chunk scan; optionally rounding where the kernel rounds.  A CPU model of
    the kernel for the tests, on no serving path.
  * :func:`ssd_decode_step` — the one-token recurrent update for serving.

Shapes: x (B,S,H,P); dt (B,S,H); A (H,); B/C (B,S,G,N) with H % G == 0 (head
h reads group h // (H/G)); D (H,).  Everything is computed in float32; y is
returned in x's dtype and the state (B,H,P,N) in float32.

One departure from the reference's arithmetic, not its values: the
intra-chunk decay ``exp(cs_i - cs_j)`` is taken only where i >= j (the
exponent is masked to −inf first).  The reference takes ``exp`` over the
whole chunk and selects afterwards, which gives the same values; an
exponent that overflows above the diagonal never reaches a product here.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ssd_naive_scan", "ssd_chunked", "ssd_passes", "ssd_decode_step", "align_chunk"]


def align_chunk(chunk: int, seq: int) -> int:
    """``min(chunk, seq)``, halved until it divides ``seq`` (the reference
    ops' ``_align``): the chunk :func:`ssd_chunked` can take."""
    chunk = min(chunk, seq)
    while seq % chunk:
        chunk //= 2
    return max(chunk, 1)


def _expand_groups(b_or_c: torch.Tensor, n_heads: int, axis: int = 2) -> torch.Tensor:
    """(…, G, N) → (…, H, N) by repeating each group H/G times (head h reads
    group h // (H/G)).  A broadcast, not ``repeat_interleave``: its gradient
    is a sum over the repeats, where ``repeat_interleave``'s adds by
    atomics on the card, in an order that changes from run to run."""
    shape = b_or_c.shape
    wide = b_or_c.unsqueeze(axis + 1).expand(*shape[:axis + 1], n_heads // shape[axis],
                                              *shape[axis + 1:])
    return wide.reshape(*shape[:axis], n_heads, *shape[axis + 1:])


def _with_d(y: torch.Tensor, D: Optional[torch.Tensor], xf: torch.Tensor) -> torch.Tensor:
    """The skip term, added in float32 before the one rounding to x's dtype."""
    if D is None:
        return y
    return y + D.float()[:, None] * xf


def ssd_naive_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, D: Optional[torch.Tensor] = None,
                   init_state: Optional[torch.Tensor] = None, return_state: bool = False):
    b, s, h, p = x.shape
    n = B.shape[-1]
    Bh = _expand_groups(B, h).float()
    Ch = _expand_groups(C, h).float()
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A.float())                       # (b, s, h)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        state = (state * decay[:, t, :, None, None]
                 + (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = _with_d(torch.stack(ys, dim=1), D, xf).to(x.dtype)
    return (y, state) if return_state else y


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, D: Optional[torch.Tensor] = None, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None, return_state: bool = False):
    """Block decomposition: a loop over S/chunk chunks carrying the state."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    Bh = _expand_groups(B, h).float()
    Ch = _expand_groups(C, h).float()
    xf, dtf, af = x.float(), dt.float(), A.float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    iq = torch.arange(chunk, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]   # (1, Q, Q, 1)
    ys = []
    for c0 in range(0, s, chunk):
        xc, dtc = xf[:, c0:c0 + chunk], dtf[:, c0:c0 + chunk]  # (b,Q,h,p), (b,Q,h)
        bc, cc = Bh[:, c0:c0 + chunk], Ch[:, c0:c0 + chunk]    # (b,Q,h,n)
        cs = torch.cumsum(dtc * af, dim=1)                     # inclusive log-decay (b,Q,h)
        # intra-chunk: L[i,j] = exp(cs_i - cs_j) for i >= j (decay j+1..i)
        li = cs[:, :, None, :] - cs[:, None, :, :]             # (b,Q,Q,h)
        L = torch.exp(torch.where(causal, li, float("-inf")))
        scores = torch.einsum("bihn,bjhn->bijh", cc, bc) * L
        y_intra = torch.einsum("bijh,bjh,bjhp->bihp", scores, dtc, xc)
        # inter-chunk: the carried state, decayed from the chunk start to i
        y_inter = torch.einsum("bihn,bhpn,bih->bihp", cc, state, torch.exp(cs))
        # state update: h' = exp(sum la) h + sum_j exp(cs_Q - cs_j) dt_j B_j x_j
        total = cs[:, -1, :]                                   # (b,h)
        decay_out = torch.exp(total[:, None, :] - cs)          # (b,Q,h)
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bjh,bjh,bjhn,bjhp->bhpn", decay_out, dtc, bc, xc)
        ys.append(y_intra + y_inter)
    y = _with_d(torch.cat(ys, dim=1), D, xf).to(x.dtype)
    return (y, state) if return_state else y


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def ssd_passes(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, D: Optional[torch.Tensor] = None, chunk: int = 64,
               kernel_rounding: bool = False, return_state: bool = False):
    """SSD from a zero state through ``csrc/ssd_tc.cu``'s three passes.

    1. chunk states ``S_c = Σ_j (x_j w_j) ⊗ B_j``, ``w_j = exp(cs_last −
       cs_j) dt_j``, with every chunk independent (P in tiles of 16 rows:
       a head dim of 8 padded with zeros, its 8 rows kept);
    2. state passing: ``in_c = state; state = exp(cs_last) state + S_c``;
    3. chunk scan: ``y_i = Σ_{j≤i} M_ij x_j + exp(cs_i) C_i · in_c + D x_i``
       with ``M = C·Bᵀ ∘ exp(cs_i − cs_j) ∘ dt_j``.

    The chunk need not divide S: the ragged last chunk is padded with zeros
    (dt = 0 keeps the cumsum flat), as the kernel masks it.  With
    ``kernel_rounding`` the products' operands are rounded where the kernel
    rounds them: the scaled ``x w`` of pass 1 is split into a bf16 high and
    a bf16 low part (both multiplied), and M and ``in_c`` are rounded once to
    bf16; every sum stays float32.  Without it everything is float32."""
    b, s, h, p = x.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t):  # (b, s, ...) -> (b, nc, chunk, ...), zero-padded
        t = t.float()
        t = torch.cat([t, t.new_zeros((b, pad, *t.shape[2:]))], dim=1) if pad else t
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xf, dtf = chunks(x), chunks(dt)                       # (b,c,Q,h,p), (b,c,Q,h)
    Bh, Ch = chunks(_expand_groups(B, h)), chunks(_expand_groups(C, h))   # (b,c,Q,h,n)
    cs = torch.cumsum(dtf * A.float(), dim=2)             # inclusive, per chunk
    total = cs[:, :, -1]                                  # (b,c,h)

    # 1. chunk states; the kernel tiles P by 16 rows, so a head dim of 8 is
    # padded with zero columns, and it keeps only the first P rows
    xw = xf * (torch.exp(total[:, :, None] - cs) * dtf)[..., None]
    p16 = -(-p // 16) * 16
    if p16 != p:
        xw = torch.cat([xw, xw.new_zeros((*xw.shape[:-1], p16 - p))], dim=-1)
    if kernel_rounding:
        hi = _bf16(xw)
        parts = (hi, _bf16(xw - hi))
    else:
        parts = (xw,)
    states = sum(torch.einsum("bcjhp,bcjhn->bchpn", part, Bh) for part in parts)[..., :p, :]

    # 2. state passing
    state = torch.zeros_like(states[:, 0])
    ins = []
    for c in range(nc):
        ins.append(state)
        state = torch.exp(total[:, c])[..., None, None] * state + states[:, c]
    ins = torch.stack(ins, dim=1)                          # (b,c,h,p,n)

    # 3. chunk scan
    iq = torch.arange(chunk, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[:, :, None]      # (Q, Q, 1)
    li = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # (b,c,Q,Q,h)
    M = (torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
         * torch.exp(torch.where(causal, li, float("-inf"))) * dtf[:, :, None])
    if kernel_rounding:
        M, ins = _bf16(M), _bf16(ins)
    y = (torch.einsum("bcijh,bcjhp->bcihp", M, xf)
         + torch.exp(cs)[..., None] * torch.einsum("bcihn,bchpn->bcihp", Ch, ins))
    y = _with_d(y.reshape(b, nc * chunk, h, p)[:, :s], D, x.float()).to(x.dtype)
    return (y, state) if return_state else y


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: Optional[torch.Tensor] = None):
    """One-token update. state (B,H,P,N) f32; x (B,H,P); dt (B,H); B/C (B,G,N).
    Returns (y (B,H,P) in x's dtype, new state in float32)."""
    h = x.shape[1]
    Bh = _expand_groups(B, h, axis=1).float()
    Ch = _expand_groups(C, h, axis=1).float()
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A.float())
    state = state * decay[..., None, None] + (dtf[..., None] * xf)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return _with_d(y, D, xf).to(x.dtype), state
