"""The comparisons that decide ``correct``.

Serving: for each sampled request, the reference runs once over the prompt
as the server padded it (left-padded with id 0 to its width, every position
attended) followed by the tokens the server delivered, and reads at each
position the gap by which the delivered token's logit lies below the
reference's best.  ``gap`` is the widest over every token compared.  The
control (:mod:`perfbench.reference.control`),
put in the program's place, reads at the same positions the gap of the
token that the lower precision puts first.

Training: the program's first steps against :func:`perfbench.reference.train.follow`
on the same initial weights and batches: ``loss`` is the largest relative
gap of a step's loss; ``grad`` and ``change`` the worst leaf's gap between
the program's norm and the reference's (of the first step's gradient as
AdamW gets it, and of the parameters' change after the last step), over
the larger of the reference's norm of that leaf and of the median leaf;
``grad_diff`` the worst leaf's norm of the difference of the two first
gradients over the same denominator.  Norms of whole leaves average
rounding away: a float8 control moves them hardly more than bfloat16 does,
where the difference itself separates them.  Leaves whose reference
gradient is under a thousandth of the median leaf's are left out.
"""
from __future__ import annotations

import statistics
from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..reference.control import FP8
from ..reference.model import RefConfig, head, hidden, strict_f32


def serve_gaps(raw: Dict[str, Any], m: RefConfig, seqs: Sequence[Tuple[Any, int, List[int]]],
               device: torch.device, control: bool = False) -> Dict[str, Any]:
    """``seqs``: (prompt ids kept, padded width, delivered tokens) each.  With
    ``control``, ``"control"`` holds the control's numbers under the same
    names."""
    strict_f32()
    gap, cgap, count = 0.0, 0.0, 0
    with torch.no_grad():
        for prompt, width, toks in seqs:
            seq = torch.zeros(width + len(toks) - 1, dtype=torch.long)
            seq[width - len(prompt):width] = torch.as_tensor(prompt, dtype=torch.long)
            seq[width:] = torch.as_tensor(toks[:-1], dtype=torch.long)
            seq = seq.to(device)
            served = torch.as_tensor(toks, dtype=torch.long, device=device)[:, None]
            lg = head(raw, m, hidden(raw, m, seq)[width - 1:])
            best = lg.max(-1).values
            gap = max(gap, float((best - lg.gather(1, served)[:, 0]).max()))
            count += len(toks)
            if control:
                lc = head(raw, m, hidden(raw, m, seq, FP8)[width - 1:], FP8)
                pick = lc.argmax(-1)[:, None]
                cgap = max(cgap, float((best - lg.gather(1, pick)[:, 0]).max()))
    out: Dict[str, Any] = {"gap": gap, "tokens": float(count)}
    if control:
        out["control"] = {"gap": cgap}
    return out


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep: Sequence[str]) -> float:
    floor = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keep)


def train_gaps(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": [per step], "grad": {leaf: norm},
    "grads": {leaf: tensor}, "change": {leaf: norm}} (the reference's from
    ``follow``)."""
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError(f"leaves differ: {sorted(set(prog['grad']) ^ set(ref['grad']))[:5]}")
    floor = statistics.median(ref["grad"].values())
    keep = [k for k, v in ref["grad"].items() if v >= 1e-3 * floor]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    floor = statistics.median(ref["grad"][k] for k in keep)
    diff = max(float(torch.linalg.vector_norm(prog["grads"][k].float() - ref["grads"][k].float()))
               / max(ref["grad"][k], floor) for k in keep)
    return {"loss": loss, "grad": _leaf_gap(prog["grad"], ref["grad"], keep), "grad_diff": diff,
            "change": _leaf_gap(prog["change"], ref["change"], keep),
            "leaves": float(len(keep)), "left_out": float(len(ref["grad"]) - len(keep))}
