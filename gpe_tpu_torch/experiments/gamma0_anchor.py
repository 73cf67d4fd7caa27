"""γ = 0 analytic anchor table, port of `gpe_tpu/experiments/gamma0_anchor.py`.

At γ > 0 our parity columns score against our float64 oracles, while the
reference's published columns scored against its unspecified reference
values; the γ = 0 rows are the one place both sides face the same ground
truth (the closed-form linear eigenvalues of `physics/exact.py`). Per
family and mode this quotes the analytic μ(γ=0), our PL-PINN |Δμ| at γ = 0
recomputed against it from our committed per-γ μ, and the reference's own
published γ = 0 "Abs Error" row.

Host only: it reads CSVs (`<runs>/comparison_results_<family>/
raw_comparison_results.csv` and the reference's counterpart under
`--ref-root`) and launches no kernel. Run:
    python -m gpe_tpu_torch.experiments.gamma0_anchor --ref-root DIR
        [--runs DIR] [--out DIR]
`--ref-root` (the JAX script's REF_ROOT) has no default: the
reference's CSVs are not part of the repository.
The table goes to `<out>/gamma0_anchor.md` (default
`runs_torch/reference_parity`). Unlike the JAX script, a family whose
committed CSV is present but whose reference CSV is missing raises and
names the file (JAX leaves the family out of the table), and a committed
oracle that has drifted from the closed form raises a ValueError (JAX
asserts, which `python -O` drops). A family without its committed CSV is
left out, as in JAX, and needs no reference file.
"""
from __future__ import annotations

import argparse
import csv
import os

from gpe_tpu_torch.physics import exact as ex

OUT_DIR = os.path.join("runs_torch", "reference_parity")

# |mu_ref − analytic| at γ = 0 beyond which the committed oracle has drifted
ORACLE_DRIFT = 5e-5

# family -> (our runs dir, reference dir, analytic μ(γ=0) fn or None)
FAMILIES = {
    "p3_harmonic": ("comparison_results_p3_harmonic",
                    "comparison_results_p3_harmonic",
                    lambda n: ex.harmonic_eigenvalue(n)),
    "neg_p3_harmonic": ("comparison_results_neg_p3_harmonic",
                        "comparison_results_neg_int_strength_p3_harmonic",
                        lambda n: ex.harmonic_eigenvalue(n)),
    "p4_harmonic": ("comparison_results_p4_harmonic",
                    "comparison_results_p4_harmonic",
                    lambda n: ex.harmonic_eigenvalue(n)),
    "p8_harmonic": ("comparison_results_p8_harmonic",
                    "comparison_results_p8_harmonic",
                    lambda n: ex.harmonic_eigenvalue(n)),
    "p16_harmonic": ("comparison_results_p16_harmonic",
                     "comparison_results_p16_harmonic",
                     lambda n: ex.harmonic_eigenvalue(n)),
    "p3_box": ("comparison_results_p3_box", "comparison_results_p3_box",
               lambda n: ex.box_eigenvalue(n)),
    "p3_gravity_well": ("comparison_results_p3_gravity_well",
                        "comparison_results_p3_gravity_well",
                        lambda n: ex.gravity_well_eigenvalue(n)),
    # Gaussian well: no closed form — the γ=0 truth is our grid-converged
    # f64 FDM oracle (validate/fdm.py), quoted instead of an analytic value
    "p3_gaussian": ("comparison_results_p3_gaussian",
                    "comparison_results_p3_gaussian", None),
}

HEADER = [
    "# γ=0 analytic anchor: ours vs the reference at the one shared "
    "ground truth",
    "",
    "Our γ>0 columns score vs our f64 oracles; the reference's vs its",
    "unspecified values (see the provenance audit). At γ=0 both face",
    "the same closed-form linear eigenvalue, so these rows anchor the",
    "cross-oracle comparison. `ours |Δμ|` is recomputed directly",
    "against the analytic value from our committed per-γ μ; `ref",
    "|Δμ|` is the reference's own published γ=0 Abs-Error row",
    "(PL-PINN method).", "",
    "| family | mode | analytic μ(γ=0) | ours PL \\|Δμ\\| | ref PL \\|Δμ\\| |",
    "|---|---|---|---|---|"]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def build_table(runs_root: str, ref_root: str) -> str:
    """The markdown table, one row per (family, PL-PINN mode) at γ = 0."""
    out = list(HEADER)
    for fam, (ours_dir, ref_dir, exact) in FAMILIES.items():
        our_path = os.path.join(runs_root, ours_dir, "raw_comparison_results.csv")
        if not os.path.exists(our_path):
            continue
        ref_path = os.path.join(ref_root, ref_dir, "raw_comparison_results.csv")
        if not os.path.exists(ref_path):
            raise FileNotFoundError(
                f"{fam}: the reference CSV {ref_path} is missing (give "
                f"--ref-root the reference's refine/ directory)")
        ours = {(r["Method"], int(r["Mode"])): r for r in _rows(our_path)
                if float(r["Gamma"]) == 0.0}
        # the reference's later families rename the method column
        refs = {(r["Method"].replace(" (ours)", ""), int(r["Mode"])): r
                for r in _rows(ref_path) if float(r["Gamma"]) == 0.0}
        modes = sorted({m for (meth, m) in ours if meth == "PL-PINN"})
        for m in modes:
            o = ours[("PL-PINN", m)]
            r = refs.get(("PL-PINN", m))
            if exact is not None:
                mu0 = exact(m)
                ours_err = abs(float(o["mu"]) - mu0)
                mu0_s = f"{mu0:.6f}"
                # a drifted committed oracle would invalidate the whole table
                gap = abs(float(o["mu_ref"]) - mu0)
                if not gap < ORACLE_DRIFT:
                    raise ValueError(
                        f"{fam} mode {m}: the committed oracle mu_ref "
                        f"{o['mu_ref']} is {gap:.3e} off the analytic "
                        f"{mu0!r} (limit {ORACLE_DRIFT:g}) in {our_path}")
            else:
                mu0 = float(o["mu_ref"])
                ours_err = abs(float(o["mu"]) - mu0)
                mu0_s = f"{mu0:.6f} (f64 FDM)"
            ref_err = f'{float(r["Abs Error"]):.2e}' if r else "—"
            out.append(f"| {fam} | {m} | {mu0_s} | {ours_err:.2e} "
                       f"| {ref_err} |")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref-root", required=True,
                    help="the reference's refine/ directory (the JAX script's REF_ROOT)")
    ap.add_argument("--runs", default="runs",
                    help="root of our comparison_results_<family>/ tables")
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory to write gamma0_anchor.md into")
    args = ap.parse_args(argv)
    table = build_table(args.runs, args.ref_root)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "gamma0_anchor.md")
    with open(path, "w") as f:
        f.write(table)
    print(f"wrote {path} ({table.count(chr(10)) - len(HEADER)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
