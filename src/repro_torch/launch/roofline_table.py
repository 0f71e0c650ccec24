"""The dry-run records as one table (the port of
``benchmarks/roofline.py``): one row per record of a directory
(``results/dryrun_torch/`` unless ``--dir`` names another, such as the
opt sweep's ``results/dryrun_torch_opt/``), in file-name order, in
markdown or CSV.  It times nothing; it only reads the records
``launch/dryrun.py`` writes.

    PYTHONPATH=src python -m repro_torch.launch.roofline_table [--markdown]
        [--mesh pod16x16] [--dir results/dryrun_torch_opt]

JAX's columns, row rules and number formats.  Where the port's record
names a field differently, the column keeps JAX's name and shows the
port's field:

  memory_s_pallas_ideal   the port's ``memory_s_ideal`` (the memory term
                          of ``analytic_min_bytes``)
  collective_s            "-": the port counts no collective
                          (``collective_bytes_per_dev`` is null), so its
                          record's 0.0 is not a measurement
"""
from __future__ import annotations

import argparse
import glob
import json
import os

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

COLS = ["arch", "shape", "mesh", "status", "compute_s", "memory_s",
        "collective_s", "bottleneck", "memory_s_pallas_ideal",
        "useful_flops_ratio", "peak_bytes"]
# JAX's column -> the port record's field (None: not counted, shown "-")
FIELDS = {"memory_s_pallas_ideal": "memory_s_ideal", "collective_s": None}


def load_records(mesh: str | None = None,
                 results_dir: str = RESULTS_DIR) -> list:
    recs = []
    for f in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if mesh and r.get("mesh") != mesh:
            continue
        recs.append(r)
    return recs


def fmt(r: dict, col: str) -> str:
    key = FIELDS.get(col, col)
    v = r.get(key) if key else None
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3g}"
    if col == "peak_bytes" and isinstance(v, int):
        return f"{v / 2**30:.1f}Gi"
    return str(v)


def render(markdown: bool = True, mesh: str | None = None,
           results_dir: str = RESULTS_DIR) -> str:
    recs = load_records(mesh, results_dir)
    lines = []
    if markdown:
        lines.append("| " + " | ".join(COLS) + " |")
        lines.append("|" + "---|" * len(COLS))
        for r in recs:
            if r.get("status") == "skip":
                lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                             f"skip ({r.get('reason', '')}) |"
                             + " - |" * (len(COLS) - 4))
            else:
                lines.append("| " + " | ".join(fmt(r, c) for c in COLS)
                             + " |")
    else:
        lines.append(",".join(COLS))
        for r in recs:
            lines.append(",".join(fmt(r, c) for c in COLS))
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--dir", default=RESULTS_DIR,
                    help="the records' directory (default: "
                         "results/dryrun_torch)")
    args = ap.parse_args(argv)
    print(render(markdown=args.markdown, mesh=args.mesh,
                 results_dir=args.dir))


if __name__ == "__main__":
    main()
