"""The frozen yardstick: the card's peaks and the work a call or a step needs.

Copied, not imported, so that the measure stays put when the program changes:

  * the peaks of ``repro_torch/launch/mesh.py`` ``HW`` (NVIDIA's data sheet of
    the H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3) and the bound
    arithmetic of ``repro_torch/launch/roofline.py`` (``bound_ms``,
    ``attention_work``);
  * ``train_flops`` of ``chip_smoke.py`` (the train MFU reading's numerator),
    with the active parameters counted here from the configuration's widths
    instead of by the program's spec tree;
  * the serving FLOPs: 2 FLOPs per multiply-add of every matrix a token
    meets, plus attention over the positions it attends.

Each function counts the work the inputs need, whatever implements it.
"""
from __future__ import annotations

from typing import Tuple

PEAK_BF16 = 989e12      # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12        # bytes/s


def bound_s(bytes_moved: float, flops: float, peak_flops: float = PEAK_BF16) -> float:
    """The least seconds a call can take: the larger of bytes over the memory
    rate and operations over the peak."""
    return max(bytes_moved / HBM_BW, flops / peak_flops)


def attention_work(b: int, s: int, h: int, kh: int, d: int, elem_bytes: int,
                   window: int = 0) -> Tuple[float, float]:
    """(bytes, FLOPs) of causal self-attention at (B, S, H, K, D): q, k, v read
    once and o written once, 4·d FLOPs per unmasked (q, k) pair: S(S+1)/2
    pairs a head, or with a window w < S, w(w+1)/2 + (S − w)·w."""
    bytes_moved = elem_bytes * d * (2 * b * s * h + 2 * b * s * kh)
    w = min(window, s) if window else s
    pairs = w * (w + 1) / 2 + (s - w) * w
    return float(bytes_moved), 4.0 * d * b * h * pairs


def matrix_params(m) -> dict:
    """Parameters of one token's matrix products, by part, from the widths of
    a reference config (:class:`perfbench.reference.model.RefConfig`):
    ``layer`` (attention projections plus the MLP, or the router plus the
    top-k experts a token runs) and ``head`` (the output projection over
    the vocabulary)."""
    attn = m.d * m.hd * (2 * m.n_heads + 2 * m.n_kv_heads)
    if m.n_experts:
        ff = m.d * m.n_experts + m.top_k * 3 * m.d * m.d_ff
    else:
        ff = 3 * m.d * m.d_ff
    return {"layer": attn + ff, "head": m.d * m.vocab}


def active_params(m) -> int:
    """The active parameters as ``ModelConfig.active_param_count`` counts
    them: every leaf of the spec tree, experts at top-k of E (norm scales
    included, the embedding and an untied head included)."""
    table = m.d * m.padded_vocab                 # the embedding, and an untied head
    norms = 0 if m.norm == "layernorm_np" else m.d * (2 * m.n_layers + 1)
    if m.qk_norm:
        norms += 2 * m.hd * m.n_layers
    return m.n_layers * matrix_params(m)["layer"] + table * (1 if m.tie else 2) + norms


def train_flops(m, batch: int, seq: int) -> float:
    """Model FLOPs of one train step, ``chip_smoke.train_flops`` for the
    dense and MoE families: 6·N per token (N the active parameters, as that
    function counts them) plus causal attention's 12·S_k·H·D per query and
    layer, S_k = S/2 on average (under a window w < S, w − w²/2S)."""
    tokens = batch * seq
    window = min(m.window or seq, seq)
    attn = 12.0 * m.n_heads * m.hd * m.n_layers * tokens * (window - window * window / (2 * seq))
    return 6.0 * active_params(m) * tokens + attn


def serve_flops(m, new: int, before: int, logits_rows: int) -> float:
    """Forward FLOPs of ``new`` tokens that follow ``before`` tokens of their
    sequence (a prefill: before 0; one decode step: new 1): the matrix
    products of every layer for each new token, causal attention of each
    over the positions up to it (4·H·D FLOPs a pair and layer), and the
    output projection for ``logits_rows`` rows."""
    p = matrix_params(m)
    pairs = new * before + new * (new + 1) / 2
    return (2.0 * new * m.n_layers * p["layer"] + 4.0 * m.n_heads * m.hd * m.n_layers * pairs
            + 2.0 * logits_rows * p["head"])
