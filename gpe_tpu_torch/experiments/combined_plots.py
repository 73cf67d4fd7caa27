"""Combined cross-family comparison plots, port of
`gpe_tpu/experiments/combined_plots.py` — the reference's
comparison_results_combined_all_potentials/ artifact set
({combined_error_comparison, combined_performance_by_interaction,
combined_average_performance_bars}.png) drawn from the per-family tables
that `paper_tables` writes (`<runs>/comparison_results_<family>/
raw_comparison_results.csv`, mode 0; a family without its table is left
out of the panels).

Reads CSVs only (no device work); imports matplotlib (`viz.plots`) when
it draws. Run:
    python -m gpe_tpu_torch.experiments.combined_plots [--runs DIR] [--out DIR]
`--runs` defaults to `runs_torch`, where the port's `paper_tables` writes;
the figures go to `<runs>/comparison_results_combined_all_potentials/`.
(`--runs runs` reads the JAX package's committed tables; give `--out`
outside `runs/`.)
"""
from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict

import numpy as np

# family dir suffix -> display name; mode 0 (the combined artifact's scope)
FAMILIES = (("p3_harmonic", "Harmonic"), ("p3_box", "Box"),
            ("p3_gravity_well", "Gravity well"), ("p3_gaussian", "Gaussian"))
METHODS = (("PL-PINN", "tab:blue"), ("PL-PINN-R", "tab:green"),
           ("Curriculum Training", "tab:orange"), ("Vanilla PINN", "tab:red"))


def _load_mode0(runs_dir: str, fam: str) -> dict:
    """{method: {gamma: rel_err_pct}} for mode 0 of one family."""
    path = os.path.join(runs_dir, f"comparison_results_{fam}",
                        "raw_comparison_results.csv")
    out: dict = defaultdict(dict)
    if not os.path.exists(path):
        return out
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            if int(row["Mode"]) != 0:
                continue
            out[row["Method"]][float(row["Gamma"])] = float(row["Rel Error"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="runs_torch")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out_dir = args.out or os.path.join(
        args.runs, "comparison_results_combined_all_potentials")

    from gpe_tpu_torch.viz.plots import _savefig, plt, use_publication_style

    use_publication_style()
    data = {fam: _load_mode0(args.runs, fam) for fam, _ in FAMILIES}

    # 1. combined_performance_by_interaction: rel-err vs γ, one panel/family
    fig, axes = plt.subplots(2, 2, figsize=(11, 8), sharex=False)
    for ax, (fam, title) in zip(axes.ravel(), FAMILIES):
        for method, color in METHODS:
            d = data[fam].get(method, {})
            if not d:
                continue
            gs = sorted(d)
            ax.semilogy(gs, [max(d[g], 1e-12) for g in gs], "o-",
                        color=color, label=method, markersize=4)
        ax.set_title(title)
        ax.set_xlabel("γ")
        ax.set_ylabel("rel. μ error (%)")
    axes[0][0].legend(loc="best", fontsize=8)
    fig.suptitle("Mode-0 eigenvalue error vs interaction strength", y=1.02)
    fig.tight_layout()
    _savefig(fig, out_dir, "combined_performance_by_interaction.png")

    # 2. combined_error_comparison: per-family mean rel-err per method (log)
    fig, ax = plt.subplots(figsize=(9, 5))
    width = 0.2
    xs = np.arange(len(FAMILIES))
    for i, (method, color) in enumerate(METHODS):
        vals = []
        for fam, _ in FAMILIES:
            d = data[fam].get(method, {})
            vals.append(np.mean(list(d.values())) if d else np.nan)
        ax.bar(xs + (i - 1.5) * width, vals, width, color=color, label=method)
    ax.set_yscale("log")
    ax.set_xticks(xs, [t for _, t in FAMILIES])
    ax.set_ylabel("mean rel. μ error over γ (%)")
    ax.legend(fontsize=8)
    ax.set_title("Mode-0 method comparison across potentials")
    _savefig(fig, out_dir, "combined_error_comparison.png")

    # 3. combined_average_performance_bars: method averages across families
    fig, ax = plt.subplots(figsize=(7, 4.5))
    names, means = [], []
    for method, color in METHODS:
        per_fam = [np.mean(list(data[fam][method].values()))
                   for fam, _ in FAMILIES if data[fam].get(method)]
        if not per_fam:
            continue
        names.append(method)
        means.append(float(np.mean(per_fam)))
    bars = ax.bar(names, means, color=[c for _, c in METHODS[:len(names)]])
    ax.set_yscale("log")
    ax.set_ylabel("mean rel. μ error (%), averaged over potentials")
    ax.bar_label(bars, fmt="%.3g")
    ax.set_title("Average mode-0 performance across all potentials")
    _savefig(fig, out_dir, "combined_average_performance_bars.png")

    print(f"wrote 3 combined plots to {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
