"""Roofline reporter: results/torch/dryrun/*.json → per-cell terms + a markdown
table, and the work each kernel of the port must do per call.

The port of ``repro/launch/roofline.py``, over the card of :data:`.mesh.HW`:

    compute_s    = traced FLOPs (per device)      / 989e12    (H100 bf16 dense peak)
    memory_s     = traced bytes (per device)      / 3.35e12   (HBM3)
    collective_s = collective bytes (per device)  / 450e9     (NVLink 4, one way, within a node)
                                                  / 50e9      (NDR InfiniBand: single, multi)

The counters come from the dry-run's depth-extrapolated traces (see
``dryrun.py``); the bottleneck is the largest term; the roofline fraction =
(useful MODEL_FLOPS per device / peak) / largest term, i.e. "what MFU would
this step run at if it hit the dominant roofline".  The fit column reads
the card's memory.

Each kernel's work formula gives the bytes a call must move (each input read
once, each output written once) and the operations it must do; the bound is
the larger of bytes over the memory rate and operations over the peak for
their type.  ``chip_smoke.py`` prints its bounds from these.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List, Tuple

from .mesh import HW

__all__ = ["load_cells", "render_table", "pick_hillclimb_cells", "bound_ms", "attention_work",
           "ssd_work", "rmsnorm_work", "moe_work", "DRYRUN_DIR"]

DRYRUN_DIR = str(Path(__file__).resolve().parents[3] / "results" / "torch" / "dryrun")


# ------------------------------------------------------------ kernel work
def bound_ms(bytes_moved: float, flops: float, peak_flops: float) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over ``peak_flops``."""
    t_bytes, t_flops = bytes_moved / HW["hbm_bw"], flops / peak_flops
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def attention_work(b: int, s: int, h: int, kh: int, d: int, elem_bytes: int,
                   window: int = 0) -> Tuple[float, float]:
    """Causal self-attention at (B, S, H, K, D): q, k, v read once and o
    written once, against 4·d FLOPs per unmasked (q, k) pair: S(S+1)/2 pairs
    a head, or with a window w < S, w(w+1)/2 + (S − w)·w."""
    bytes_moved = elem_bytes * d * (2 * b * s * h + 2 * b * s * kh)
    w = min(window, s) if window else s
    pairs = w * (w + 1) / 2 + (s - w) * w
    return float(bytes_moved), 4.0 * d * b * h * pairs


def ssd_work(b: int, s: int, h: int, p: int, n: int, g: int, elem_bytes: int,
             chunk: int) -> Tuple[float, float]:
    """The SSD forward at these shapes: x, B, C, dt, A, D read once, y and the
    f32 final state written once, against the chunked algorithm's FLOPs at
    ``chunk``: the causal half of C·Bᵀ once per group (every head of a group
    shares it), and per head the causal half of the intra-chunk product and
    the inter-chunk and state products."""
    bytes_moved = (elem_bytes * (2 * b * s * h * p + 2 * b * s * g * n)
                   + 4 * (b * s * h + 2 * h) + 4 * b * h * p * n)
    flops = 0.0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs = q * (q + 1) / 2
        flops += 2.0 * b * g * pairs * n + 2.0 * b * h * (pairs * p + 2 * q * n * p)
    return float(bytes_moved), flops


def rmsnorm_work(rows: int, d: int, elem_bytes: int, scale_bytes: int,
                 residual: bool) -> Tuple[float, float]:
    """RMSNorm: x (and the residual) read once, the scale read once, y
    written once, against 4 FLOPs per element (square and add, the two
    multiplies; 5 with the residual's add), at the card's float32 rate."""
    n = rows * d
    return (float(elem_bytes * n * (3 if residual else 2) + scale_bytes * d),
            (5.0 if residual else 4.0) * n)


def moe_work(tokens: int, d: int, f: int, n_experts: int, touched: int, assignments: int,
             elem_bytes: int) -> Tuple[float, float]:
    """A MoE layer on one routing: x read once and y written once, the router
    and the ``touched`` experts' three weights read once, against the
    router's product and 6·d·f FLOPs per (token, expert) assignment."""
    bytes_moved = elem_bytes * (2 * tokens * d + d * n_experts + 3 * touched * d * f)
    return float(bytes_moved), 2.0 * tokens * d * n_experts + 6.0 * assignments * d * f


# ------------------------------------------------------------ the table
def load_cells(out_dir: str = DRYRUN_DIR, tag: str = "") -> List[Dict[str, Any]]:
    cells = []
    for p in sorted(Path(out_dir).glob("*.json")):
        rec = json.loads(p.read_text())
        if tag:
            if not p.stem.endswith(f"__{tag}"):
                continue
        elif p.stem.count("__") > 2:
            continue  # perf-experiment files excluded from the baseline table
        rec["_file"] = p.name
        cells.append(rec)
    return cells


def _fmt_s(x: float) -> str:
    return f"{x*1e3:9.2f}ms" if x < 10 else f"{x:8.2f}s "


def render_table(cells: List[Dict[str, Any]], mesh: str = "one") -> str:
    """The reference's table; on a sharded mesh a last column adds the
    collective bytes a device moves a step."""
    sharded = mesh != "one"
    rows = []
    head = ("| arch | shape | status | mem | fits | compute | memory | collective "
            "| bound | MODEL/traced flops | roofline frac |" + (" coll bytes |" if sharded else ""))
    sep = "|" + "---|" * (12 if sharded else 11)
    rows.append(head)
    rows.append(sep)
    blank = " – |" * (9 if sharded else 8)
    for c in cells:
        if c.get("mesh") != mesh:
            continue
        if c["status"] == "skip":
            rows.append(f"| {c['arch']} | {c['shape']} | SKIP |" + blank)
            continue
        if c["status"] == "error":
            rows.append(f"| {c['arch']} | {c['shape']} | ERROR |" + blank)
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | ok "
            f"| {c['per_device_bytes']/1e9:.1f} GB "
            f"| {'✓' if c['fits'] else '✗'} "
            f"| {_fmt_s(r['compute_s'])} | {_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} "
            f"| {c['bottleneck'].replace('_s','')} "
            f"| {c['useful_flops_ratio']:.3f} | {c.get('roofline_fraction', 0.0):.4f} |"
            + (f" {c['counters']['collective_bytes'] / 1e9:.2f} GB |" if sharded else ""))
    return "\n".join(rows)


def pick_hillclimb_cells(cells: List[Dict[str, Any]], mesh: str = "one") -> Dict[str, str]:
    """The three perf cells: worst roofline fraction, most collective-bound,
    most paper-representative (largest tunable surface = the MoE train cell)."""
    ok = [c for c in cells if c["status"] == "ok" and c.get("mesh") == mesh]
    worst = min(ok, key=lambda c: c.get("roofline_fraction", 1.0))
    coll = max(ok, key=lambda c: c["roofline"]["collective_s"] / max(max(c["roofline"].values()), 1e-12))
    moe_train = [c for c in ok if c["shape"] == "train_4k" and "olmoe" in c["arch"]]
    rep = moe_train[0] if moe_train else ok[0]
    return {
        "worst_fraction": f"{worst['arch']}/{worst['shape']}",
        "most_collective_bound": f"{coll['arch']}/{coll['shape']}",
        "paper_representative": f"{rep['arch']}/{rep['shape']}",
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DRYRUN_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default="one", choices=["one", "single", "multi"])
    args = ap.parse_args()
    cells = load_cells(args.dir, args.tag)
    print(render_table(cells, args.mesh))
    ok = [c for c in cells if c["status"] == "ok" and c.get("mesh") == args.mesh]
    if len(ok) >= 3:
        print("\nhillclimb candidates:", json.dumps(pick_hillclimb_cells(cells, args.mesh),
                                                    indent=1))


if __name__ == "__main__":
    main()
