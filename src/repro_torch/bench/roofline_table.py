"""Render the roofline table from the port's dry-run sweep.

The twin of the reference's ``benchmarks/roofline_table.py``: the records
``python -m repro_torch.launch.dryrun --all`` wrote under
``results/torch/dryrun/``, one table per mesh that has records (``one``: the
card; ``single``, ``multi``: rank 0 of the sharded program, each device an
H100), and each mesh's three hillclimb cells.

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
                "`PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh all` first")
        print(text)
        return text
    parts = []
    for mesh in ("one", "single", "multi"):
        if any(c.get("mesh") == mesh for c in cells):
            parts.append(f"\n### mesh {mesh}\n" + render_table(cells, mesh))
            if sum(c["status"] == "ok" and c.get("mesh") == mesh for c in cells) >= 3:
                parts.append(f"\nhillclimb cells ({mesh}): "
                             + json.dumps(pick_hillclimb_cells(cells, mesh)))
    text = "\n".join(parts)
    print(text)
    return text


if __name__ == "__main__":
    main()
