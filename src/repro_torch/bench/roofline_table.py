"""Render the roofline table from the port's dry-run sweep.

The twin of the reference's ``benchmarks/roofline_table.py``: the records
``python -m repro_torch.launch.dryrun --all`` wrote under
``results/torch/dryrun/``, one table per mesh that has records (``one``: the
card's fit and roofline; ``single``, ``multi``: each device's state under
the sharding rules), and the three hillclimb cells.

    PYTHONPATH=src python -m repro_torch.bench.roofline_table
"""
from __future__ import annotations

import json
from typing import Optional

from ..launch.roofline import DRYRUN_DIR, load_cells, pick_hillclimb_cells, render_table


def main(out_dir: Optional[str] = None) -> str:
    """Print the tables; returns what was printed."""
    cells = load_cells(out_dir or DRYRUN_DIR)
    if not cells:
        text = ("roofline: no dry-run results yet — run "
                "`PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh one` first")
        print(text)
        return text
    parts = []
    for mesh in ("one", "single", "multi"):
        if any(c.get("mesh") == mesh for c in cells):
            parts.append(f"\n### mesh {mesh}\n" + render_table(cells, mesh))
    ok = [c for c in cells if c["status"] == "ok" and c.get("mesh") == "one"]
    if len(ok) >= 3:
        parts.append("\nhillclimb cells: " + json.dumps(pick_hillclimb_cells(cells, "one")))
    text = "\n".join(parts)
    print(text)
    return text


if __name__ == "__main__":
    main()
