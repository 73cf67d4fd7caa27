"""Hold the two report scripts (`reference_compare`, `gamma0_anchor`) to
the committed tables `runs/reference_parity/{parity,gamma0_anchor}.md`.

The reference's CSVs are not in the repository, so `reference_from_tables`
writes a stand-in reference tree whose published cells are those the
committed tables quote (the "ref" columns); the reports are then built on
the committed `runs/` and that tree, and `check_committed` compares each
row's "ours" cells, which come from our committed CSVs alone, with the
committed table's. One row of the committed anchor table is stale
(`STALE_ANCHOR`): the Gaussian family's CSV was written again after the
table.

Host only; no kernel. Run:
    python -m gpe_tpu_torch.experiments.report_check [--runs DIR]
prints one JSON object (rows, equal rows, the rows that differ, and `ok`:
every parity row equal and the anchor table off in its stale row alone).
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import tempfile

from gpe_tpu_torch.experiments import gamma0_anchor, reference_compare

# (family, mode) of the committed anchor table's stale row, and its cells
# (analytic μ, ours) as recomputed from the committed CSV and as committed
STALE_ANCHOR = {("p3_gaussian", "0"): (("10.741232 (f64 FDM)", "1.39e-06"),
                                       ("10.741233 (f64 FDM)", "2.13e-06"))}

# cells of a row that come from our CSVs alone (the rest quote the reference)
PARITY_OURS = (0, 1, 2, 3, 4, 5, 7, 9, 11)
ANCHOR_OURS = (0, 1, 2, 3)
_REF_CELLS = {6: "PL-PINN (ours)", 8: "Curriculum Training", 10: "Regular PINN"}


def table_rows(md: str) -> list:
    """The cells of each row of a report's table whose first cell names a
    family."""
    rows = []
    for line in md.splitlines():
        if line.startswith("| "):
            cells = [c.strip() for c in line.strip().strip("|").split(" | ")]
            if cells[0] in gamma0_anchor.FAMILIES:
                rows.append(cells)
    return rows


def reference_from_tables(parity_md: str, anchor_md: str, root: str) -> None:
    """Write under `root` the reference CSVs that reproduce the "ref"
    columns of the two tables: `comparison_results_<ref family>/
    paper_style_results.csv` (Mode, Method, abs_err, rel_err) and
    `raw_comparison_results.csv` (the γ = 0 PL-PINN Abs Error rows)."""
    papers: dict = {}
    for c in table_rows(parity_md):
        ref_fam = reference_compare.FAMILIES[c[0]]
        for i, method in _REF_CELLS.items():
            v = c[i].rstrip("†")
            if v != "—":
                # the tables quote the reference's rel% for PL-PINN only
                rel = c[12] + "%" if i == 6 else "nan"
                papers.setdefault(ref_fam, []).append(
                    (f"Mode {c[1]}", method, v, rel))
    for ref_fam, rows in papers.items():
        d = os.path.join(root, f"comparison_results_{ref_fam}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "paper_style_results.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Mode", "Method", "abs_err", "rel_err"])
            w.writerows(rows)
    raws: dict = {}
    for c in table_rows(anchor_md):
        if c[4] != "—":
            raws.setdefault(gamma0_anchor.FAMILIES[c[0]][1], []).append(
                ("PL-PINN (ours)", c[1], "0.0", c[4]))
    for ref_dir, rows in raws.items():
        d = os.path.join(root, ref_dir)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "raw_comparison_results.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Method", "Mode", "Gamma", "Abs Error"])
            w.writerows(rows)


def _compare(built: str, committed: str, ours: tuple) -> dict:
    got, want = table_rows(built), table_rows(committed)
    keys = [tuple(c[:2]) for c in got]
    if keys != [tuple(c[:2]) for c in want]:
        raise ValueError(f"row order differs: {keys} against "
                         f"{[tuple(c[:2]) for c in want]}")
    differ = [{"row": list(k), "built": [g[i] for i in ours],
               "committed": [w[i] for i in ours]}
              for k, g, w in zip(keys, got, want)
              if [g[i] for i in ours] != [w[i] for i in ours]]
    return {"rows": len(got), "equal": len(got) - len(differ),
            "differ": differ, "identical": built == committed}


def check_committed(runs_root: str = "runs", work_dir: str | None = None) -> dict:
    """Both reports on `runs_root` and the stand-in reference tree, each
    row's "ours" cells against the committed tables under
    `<runs_root>/reference_parity/`."""
    with open(os.path.join(runs_root, "reference_parity", "parity.md")) as f:
        parity_md = f.read()
    with open(os.path.join(runs_root, "reference_parity", "gamma0_anchor.md")) as f:
        anchor_md = f.read()
    with tempfile.TemporaryDirectory(dir=work_dir) as ref:
        reference_from_tables(parity_md, anchor_md, ref)
        parity = reference_compare.build_table(runs_root, ref)
        anchor = gamma0_anchor.build_table(runs_root, ref)
    out = {"parity": _compare(parity, parity_md, PARITY_OURS),
           "gamma0_anchor": _compare(anchor, anchor_md, ANCHOR_OURS)}
    stale = {(*d["row"],): (tuple(d["built"][2:]), tuple(d["committed"][2:]))
             for d in out["gamma0_anchor"]["differ"]}
    out["ok"] = not out["parity"]["differ"] and stale == STALE_ANCHOR
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default="runs")
    args = ap.parse_args(argv)
    print(json.dumps(check_committed(args.runs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
