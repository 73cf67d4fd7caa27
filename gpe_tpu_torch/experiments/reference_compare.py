"""Ours-vs-reference parity table, port of
`gpe_tpu/experiments/reference_compare.py`.

Reads every regenerated comparison family under
`<runs>/comparison_results_*/` and the reference's counterpart under
`--ref-root` (`paper_style_results.csv` on both sides) and emits a
per-(family, mode) markdown table of mean-|Δμ| errors: our PL-PINN /
PL-PINN-R / PL-PINN+LM / Curriculum / Vanilla columns against the
reference's PL-PINN / Curriculum / Regular-or-Vanilla columns, with the †
flags of `<runs>/reference_parity/provenance_audit.json`, the ± column of
`<runs>/seed_stats_<family>.json` and the gravity well's ramp025 footnote
where those are committed.

Our errors are measured against our float64 Newton-continuation FDM
oracle, the reference's against unspecified "reference values" that its
own artifacts cannot reproduce (RESULTS.md provenance audit), so the
relative errors are the only like-for-like column for the box / gravity /
Gaussian families, where the μ normalization differs.

Host only: it reads CSVs and JSON and launches no kernel. Run:
    python -m gpe_tpu_torch.experiments.reference_compare --ref-root DIR
        [--runs DIR] [--write DIR]
`--ref-root` (the JAX script's REF_ROOT) has no default: the
reference's CSVs are not part of the repository.
The table is printed and written to `<write>/parity.md` (default
`runs_torch/reference_parity`). Unlike the JAX script, a family whose
committed table is present but whose reference table is missing raises
and names the file (JAX prints "—" in its reference columns); a family
without its committed table is left out, as in JAX, and needs no
reference file.
"""
from __future__ import annotations

import argparse
import csv
import json
import os

OUT_DIR = os.path.join("runs_torch", "reference_parity")

# ours dir name -> reference dir name
FAMILIES = {
    "p3_harmonic": "p3_harmonic",
    "p3_box": "p3_box",
    "p3_gravity_well": "p3_gravity_well",
    "p3_gaussian": "p3_gaussian",
    "p4_harmonic": "p4_harmonic",
    "p8_harmonic": "p8_harmonic",
    "p16_harmonic": "p16_harmonic",
    "neg_p3_harmonic": "neg_int_strength_p3_harmonic",
}

# method-name normalization (the reference uses both "Regular PINN" and
# "Vanilla PINN" across families)
REF_METHODS = {"PL-PINN": "PL", "PL-PINN (ours)": "PL",
               "Curriculum Training": "Curriculum",
               "Regular PINN": "Vanilla", "Vanilla PINN": "Vanilla"}
OUR_METHODS = {"PL-PINN": "PL", "PL-PINN-R": "PL-R", "PL-PINN+LM": "PL+LM",
               "PL-PINN-R+LM": "PL-R+LM",
               "Curriculum Training": "Curriculum",
               "Vanilla PINN": "Vanilla"}


def _load(path: str, mapping: dict) -> dict:
    """{(mode, method): (abs_err, rel_err_pct)} from a paper_style CSV;
    {} where the file is missing."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            method = mapping.get(row["Method"].strip())
            if method is None:
                continue
            mode = row["Mode"].strip()
            abs_e = float(row["abs_err"].replace("*", ""))
            rel_key = "rel_err_pct" if "rel_err_pct" in row else "rel_err"
            rel = float(row[rel_key].replace("*", "").replace("%", ""))
            out[(mode, method)] = (abs_e, rel)
    return out


def _load_flags(runs_root: str) -> dict:
    """(family, mode, method) -> ratio for published reference cells the
    committed reference artifacts cannot reproduce (ratio = mean |Δμ| of the
    reference's own committed model pickles over its published claim, from
    benchmarks/audit_reference_pickles.py; > 3× flags the cell)."""
    path = os.path.join(runs_root, "reference_parity", "provenance_audit.json")
    flags = {}
    if not os.path.exists(path):
        return flags
    with open(path) as f:
        audit = json.load(f)
    meth_of = {"regular": "Vanilla", "curriculum": "Curriculum"}
    for fam, by_kind in audit.items():
        for kind, by_mode in by_kind.items():
            for mode, v in by_mode.items():
                r = v.get("ratio_committed_over_published")
                if r is not None and r > 3.0:
                    flags[(fam, mode, meth_of[kind])] = r
    return flags


def _load_seed_stats(runs_root: str, fam: str) -> dict:
    """(mode_str, short_method) -> {cell_median, cell_std, n} from the
    multi-seed run (experiments/seed_stats.py), when committed."""
    path = os.path.join(runs_root, f"seed_stats_{fam}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    out = {}
    for mode, per in data.get("modes", {}).items():
        for meth_long, key in (("PL-PINN", "PL"), ("PL-PINN-R", "PL-R")):
            if meth_long in per:
                out[(mode, key)] = {**per[meth_long], "n": data.get("n_seeds")}
    return out


def build_table(runs_root: str, ref_root: str) -> str:
    flags = _load_flags(runs_root)
    seeded_families = []
    lines = [
        "# Parity vs the reference's published comparison tables",
        "",
        "Mean-over-γ |Δμ| per (family, mode). Ours vs our float64 FDM oracle;",
        "reference vs its unspecified published values (see RESULTS.md",
        "provenance audit). `rel%` columns are the apples-to-apples",
        "comparison where μ normalization differs (box/gravity/gaussian).",
        "",
        "| family | mode | ours PL | ours PL-R | ours PL+LM | ours PL-R+LM "
        "| ref PL | ours Curr | ref Curr | ours Van | ref Van | "
        "ours PL rel% | ref PL rel% |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    fmt = lambda v: f"{v:.2e}" if v is not None else "—"  # noqa: E731
    for fam, ref_fam in FAMILIES.items():
        ours = _load(os.path.join(runs_root, f"comparison_results_{fam}",
                                  "paper_style_results.csv"), OUR_METHODS)
        if not ours:
            continue
        ref_path = os.path.join(ref_root, f"comparison_results_{ref_fam}",
                                "paper_style_results.csv")
        if not os.path.exists(ref_path):
            raise FileNotFoundError(
                f"{fam}: the reference CSV {ref_path} is missing (give "
                f"--ref-root the reference's refine/ directory)")
        ref = _load(ref_path, REF_METHODS)
        sstats = _load_seed_stats(runs_root, fam)
        if sstats:
            seeded_families.append(fam)
        modes = sorted({m for m, _ in ours}, key=lambda s: int(s.split()[-1]))
        for mode in modes:
            g = lambda d, meth, i=0: (d.get((mode, meth)) or (None, None))[i]  # noqa: E731
            mnum = mode.split()[-1]

            def ref_cell(meth):
                mark = "†" if (fam, mnum, meth) in flags else ""
                return fmt(g(ref, meth)) + mark

            def our_pl_cell(meth):
                """single-seed (42) cell + across-seed std when committed."""
                base = fmt(g(ours, meth))
                ss = sstats.get((mnum, meth))
                return base if ss is None else f"{base} ±{ss['cell_std']:.0e}"

            lines.append(
                f"| {fam} | {mnum} | {our_pl_cell('PL')} | "
                f"{our_pl_cell('PL-R')} | {fmt(g(ours, 'PL+LM'))} | "
                f"{fmt(g(ours, 'PL-R+LM'))} | "
                f"{fmt(g(ref, 'PL'))} | {fmt(g(ours, 'Curriculum'))} | "
                f"{ref_cell('Curriculum')} | {fmt(g(ours, 'Vanilla'))} | "
                f"{ref_cell('Vanilla')} | {fmt(g(ours, 'PL', 1))} | "
                f"{fmt(g(ref, 'PL', 1))} |")
    if flags:
        worst = max(flags.values())
        lines += [
            "",
            "† unreproducible: evaluating the reference's OWN committed "
            "model pickles with its own Rayleigh-μ convention misses this "
            "published cell by the shown-in-audit factor (3×–"
            f"{worst:.0f}×; benchmarks/audit_reference_pickles.py → "
            "runs/reference_parity/provenance_audit.json). The producing "
            "script for both the pickles and the published CSVs is absent "
            "from the reference repository.",
        ]
    ramp025 = os.path.join(runs_root, "comparison_results_p3_gravity_well",
                           "ramp025", "summary.json")
    if os.path.exists(ramp025):
        with open(ramp025) as f:
            v = next((r["abs_err"] for r in json.load(f)["rows"]
                      if r["Method"] == "PL-PINN" and r["Mode"] == "Mode 0"),
                     None)
        if v is not None:
            lines += [
                "",
                "Gravity-well faithful-protocol footnote: at the "
                "reference's OWN Δγ=0.25/401-step ramp "
                "(gravity_well_pinn_simulation.py main block) our plain "
                f"PL mode-0 row is {v:.2e} — vs {9.86e-06:.2e} on the "
                "harder Δγ=0.5 ramp the main table uses, and the published "
                "2.50e-3 (runs/comparison_results_p3_gravity_well/ramp025/).",
            ]
    if seeded_families:
        lines += [
            "",
            "± columns (families: " + ", ".join(seeded_families) + "): "
            "across-seed std of the per-seed mean-over-γ |Δμ| from the "
            "multi-seed ensembles (runs/seed_stats_*.json, "
            "experiments/seed_stats.py — ≥6 seeds vs the reference's 5-seed "
            "median±std protocol, "
            "plot_box_potential_at_ground_state_multiple_runs.py:987-1055); "
            "the point value remains the committed seed-42 run.",
        ]
    lines += [
        "",
        "γ=0 analytic anchor (both sides vs the closed-form linear "
        "eigenvalue): runs/reference_parity/gamma0_anchor.md.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref-root", required=True,
                    help="the reference's refine/ directory (the JAX script's REF_ROOT)")
    ap.add_argument("--runs", default="runs",
                    help="root of our comparison_results_<family>/ tables")
    ap.add_argument("--write", default=OUT_DIR,
                    help="directory to write parity.md into")
    args = ap.parse_args(argv)
    table = build_table(args.runs, args.ref_root)
    print(table)
    os.makedirs(args.write, exist_ok=True)
    with open(os.path.join(args.write, "parity.md"), "w") as f:
        f.write(table)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
