"""Structured metrics and error tables, port of `gpe_tpu/utils/metrics.py`:
`MetricsLogger` collects host scalars into columns with CSV/JSONL export,
and `write_error_table` writes the paper-style comparison table (abs/rel μ
error per row) as CSV and a LaTeX tabular, byte for byte as the JAX package
writes them.
"""
from __future__ import annotations

import csv
import json
import os
import time
from collections import defaultdict


class MetricsLogger:
    """Append scalars per step; export CSV/JSONL. Host-side: call it with
    already-materialised floats (e.g. once per check_every chunk)."""

    def __init__(self, run_name: str = "run"):
        self.run_name = run_name
        self.columns = defaultdict(list)
        self.steps = []
        self._t0 = time.time()

    def log(self, step: int, **scalars):
        self.steps.append(step)
        self.columns["wall_s"].append(time.time() - self._t0)
        for k, v in scalars.items():
            self.columns[k].append(float(v))

    def to_csv(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        keys = sorted(self.columns)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step"] + keys)
            for i, s in enumerate(self.steps):
                w.writerow([s] + [self.columns[k][i] if i < len(self.columns[k]) else ""
                                  for k in keys])
        return path

    def to_jsonl(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        keys = sorted(self.columns)
        with open(path, "w") as f:
            for i, s in enumerate(self.steps):
                f.write(json.dumps({"step": s, **{k: self.columns[k][i] for k in keys
                                                  if i < len(self.columns[k])}}) + "\n")
        return path


def write_error_table(rows: list[dict], out_dir: str, stem: str = "paper_style_results",
                      mu_key: str = "mu", ref_key: str = "mu_ref"):
    """Paper-style comparison table: one row per entry of `rows` with the
    absolute and relative (%) μ error added where both keys are present;
    writes <stem>.csv and a LaTeX tabular <stem>.tex. Returns both paths."""
    os.makedirs(out_dir, exist_ok=True)
    enriched = []
    for r in rows:
        r = dict(r)
        if ref_key in r and mu_key in r:
            r["abs_error"] = abs(r[mu_key] - r[ref_key])
            r["rel_error_pct"] = 100.0 * r["abs_error"] / max(abs(r[ref_key]), 1e-30)
        enriched.append(r)
    keys = sorted({k for r in enriched for k in r})
    csv_path = os.path.join(out_dir, f"{stem}.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(enriched)
    tex_path = os.path.join(out_dir, f"{stem}.tex")
    with open(tex_path, "w") as f:
        f.write("\\begin{tabular}{" + "l" * len(keys) + "}\n\\hline\n")
        f.write(" & ".join(k.replace("_", "\\_") for k in keys) + " \\\\\n\\hline\n")
        for r in enriched:
            cells = []
            for k in keys:
                v = r.get(k, "")
                cells.append(f"{v:.3e}" if isinstance(v, float) else str(v))
            f.write(" & ".join(cells) + " \\\\\n")
        f.write("\\hline\n\\end{tabular}\n")
    return csv_path, tex_path
