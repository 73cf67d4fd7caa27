"""The report scripts (`experiments/reference_compare.py`,
`experiments/gamma0_anchor.py`) against the JAX package's on the CPU.

A fixture tree of both sides' CSVs under tmp_path goes through JAX's
`main` / `build_table` (its REF_ROOT monkeypatched to the fixture, the
working directory moved to tmp_path) and through the port's: the markdown
must be byte-equal. On the committed `runs/`, the port's "ours" cells
must equal the committed tables (`report_check`). The faults of the
reference that the port does not inherit are planted: a missing reference
file raises and names it; a drifted oracle raises, under `python -O` too.
"""
import csv
import json
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402

from gpe_tpu.experiments import gamma0_anchor as jg  # noqa: E402
from gpe_tpu.experiments import reference_compare as jr  # noqa: E402
from gpe_tpu_torch.experiments import gamma0_anchor as tg  # noqa: E402
from gpe_tpu_torch.experiments import reference_compare as tr  # noqa: E402
from gpe_tpu_torch.experiments import report_check  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# (our family, the analytic μ(γ=0) of modes 0, 1 or None): the Gaussian
# family has no closed form
OURS = {"p3_harmonic": (1.0, 3.0), "p3_box": (9.869604401089358, 39.47841760435743),
        "p3_gaussian": None, "neg_p3_harmonic": (1.0, 3.0)}
OUR_PAPER = ("PL-PINN", "PL-PINN-R", "PL-PINN+LM", "PL-PINN-R+LM",
             "Curriculum Training", "Vanilla PINN", "Some Other Method")


def _write_csv(path: Path, header, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _fixture(tmp: Path, extras: bool = True) -> Path:
    """Our runs/ and a reference tree under tmp; returns the reference root.
    extras: the provenance audit (one ratio above 3, one below, one None),
    a seed_stats file and the gravity well's ramp025 summary."""
    runs, ref = tmp / "runs", tmp / "ref"
    for fi, (fam, exact) in enumerate(OURS.items()):
        modes = (0,) if exact is None else (0, 1)
        raw = []
        for m in modes:
            mu0 = 10.741232 + 1e-6 if exact is None else exact[m]
            for g in (0.0, 20.0):
                for meth in ("PL-PINN", "PL-PINN-R"):
                    mu = mu0 + 1.7e-6 * (m + 1) * (fi + 1) + (0.3 * g if g else 0.0)
                    ref_mu = mu0 + (2e-6 if exact is not None else 0.0) + 0.3 * g
                    raw.append((meth, m, g, repr(mu), repr(ref_mu), abs(mu - ref_mu),
                                abs(mu - ref_mu) / ref_mu))
        d = runs / f"comparison_results_{fam}"
        _write_csv(d / "raw_comparison_results.csv",
                   ["Method", "Mode", "Gamma", "mu", "mu_ref", "Abs Error", "Rel Error"], raw)
        paper = [(f"Mode {m}", meth, f"{1.234e-5 * (k + 1) * (m + 1) * (fi + 2):.2e}"
                  + ("*" if k == 2 else ""), f"{0.0002426 * (k + 1) * (m + 2):.7f}%")
                 for m in modes for k, meth in enumerate(OUR_PAPER)]
        _write_csv(d / "paper_style_results.csv",
                   ["Mode", "Method", "abs_err", "rel_err_pct"], paper)
        # the reference: its later families rename PL-PINN and Vanilla PINN
        # and give rel_err for rel_err_pct; one family lacks mode 1's γ=0 row
        rfam = jr.FAMILIES[fam]
        pl = "PL-PINN (ours)" if fi % 2 else "PL-PINN"
        van = "Regular PINN" if fi < 2 else "Vanilla PINN"
        rel_key = "rel_err" if fi % 2 else "rel_err_pct"
        rpaper = [(f"Mode {m}", meth, f"{6.99e-5 * (k + 1) * (m + 1):.2e}"
                   + ("*" if k == 1 else ""), f"{0.038 * (k + 1):.3f}" + ("%" if fi else ""))
                  for m in modes for k, meth in enumerate((pl, "Curriculum Training", van))]
        _write_csv(ref / f"comparison_results_{rfam}" / "paper_style_results.csv",
                   ["Mode", "Method", "abs_err", rel_key], rpaper)
        rraw = [(pl, m, g, f"{3.12e-4 * (m + 1) * (fi + 1):.6g}")
                for m in modes for g in (0.0, 20.0) if not (fam == "p3_box" and m == 1)]
        _write_csv(ref / jg.FAMILIES[fam][1] / "raw_comparison_results.csv",
                   ["Method", "Mode", "Gamma", "Abs Error"], rraw)
    if extras:
        audit = {"p3_harmonic": {"regular": {"0": {"ratio_committed_over_published": 27.4},
                                             "1": {"ratio_committed_over_published": 2.9}},
                                 "curriculum": {"1": {"ratio_committed_over_published": 3.5},
                                                "0": {"ratio_committed_over_published": None}}}}
        (runs / "reference_parity").mkdir(parents=True)
        (runs / "reference_parity" / "provenance_audit.json").write_text(json.dumps(audit))
        (runs / "seed_stats_p3_box.json").write_text(json.dumps({
            "n_seeds": 6, "modes": {"0": {"PL-PINN": {"cell_median": 1e-5, "cell_std": 3.3e-6},
                                          "PL-PINN-R": {"cell_median": 2e-5,
                                                        "cell_std": 4.6e-5}}}}))
        ramp = runs / "comparison_results_p3_gravity_well" / "ramp025"
        ramp.mkdir(parents=True)
        (ramp / "summary.json").write_text(json.dumps({"rows": [
            {"Method": "PL-PINN-R", "Mode": "Mode 0", "abs_err": 1.0},
            {"Method": "PL-PINN", "Mode": "Mode 0", "abs_err": 6.38e-06}]}))
    return ref


@pytest.mark.parametrize("extras", [True, False], ids=["extras", "bare"])
def test_reports_byte_equal_to_jax_on_a_fixture(tmp_path, monkeypatch, extras):
    """Both scripts, JAX's and the port's, on one fixture tree: the same
    markdown byte for byte (renamed methods, `*` and `%` marks, † flags, the
    ± column, the ramp025 footnote, the row order, a missing reference row's
    "—"); the port writes under runs_torch/reference_parity/ by default and
    leaves runs/ alone."""
    ref = _fixture(tmp_path, extras)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jg, "REF_ROOT", str(ref))
    monkeypatch.setattr(jr, "REF_ROOT", str(ref))
    assert jg.main() == 0
    want_anchor = (tmp_path / "runs" / "reference_parity" / "gamma0_anchor.md").read_bytes()
    want_parity = jr.build_table().encode()
    before = sorted(p for p in (tmp_path / "runs").rglob("*"))

    assert tg.main(["--ref-root", str(ref)]) == 0
    assert tr.main(["--ref-root", str(ref)]) == 0
    out = tmp_path / "runs_torch" / "reference_parity"
    assert (out / "gamma0_anchor.md").read_bytes() == want_anchor
    assert (out / "parity.md").read_bytes() == want_parity
    assert sorted(p for p in (tmp_path / "runs").rglob("*")) == before
    assert tr.build_table("runs", str(ref)).encode() == want_parity
    assert tg.build_table("runs", str(ref)).encode() == want_anchor

    text = want_parity.decode()
    assert ("†" in text) == extras and ("±" in text) == extras
    assert ("6.38e-06" in text) == extras
    assert "—" not in {c for row in report_check.table_rows(text) for c in row}
    assert "| p3_box | 1 |" in want_anchor.decode() and "| — |" in want_anchor.decode()
    assert "10.741233 (f64 FDM)" in want_anchor.decode()   # no closed form
    rows = [r[:2] for r in report_check.table_rows(text)]
    assert rows == [[f, str(m)] for f in tr.FAMILIES if f in OURS
                    for m in ((0,) if OURS[f] is None else (0, 1))]


def test_a_family_without_its_committed_csv_needs_no_reference(tmp_path, monkeypatch):
    """A family whose own CSVs are missing is left out, as in JAX, and its
    reference files may be missing too."""
    ref = _fixture(tmp_path)
    for p in (tmp_path / "runs" / "comparison_results_p3_box").glob("*.csv"):
        p.unlink()
    for p in ref.rglob("*p3_box/*.csv"):
        p.unlink()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jg, "REF_ROOT", str(ref))
    monkeypatch.setattr(jr, "REF_ROOT", str(ref))
    assert jg.main() == 0
    assert tg.build_table("runs", str(ref)) == \
        (tmp_path / "runs" / "reference_parity" / "gamma0_anchor.md").read_text()
    assert tr.build_table("runs", str(ref)) == jr.build_table()
    assert "p3_box" not in tr.build_table("runs", str(ref))


def _shift_mu_ref(tmp_path):
    """Our p3_harmonic mode-1 oracle at γ = 0 moved by 1e-4 (limit 5e-5)."""
    path = tmp_path / "runs" / "comparison_results_p3_harmonic" / "raw_comparison_results.csv"
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        if r["Mode"] == "1" and float(r["Gamma"]) == 0.0:
            r["mu_ref"] = repr(float(r["mu_ref"]) + 1e-4)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


@pytest.mark.parametrize("fault", ["anchor_ref_missing", "parity_ref_missing",
                                   "mu_ref_shifted", "mu_ref_shifted_under_O"])
def test_planted_faults_raise(tmp_path, fault):
    """A missing reference file raises and names it (JAX drops the family
    or prints "—"); a committed oracle 1e-4 off the closed form raises a
    ValueError naming the family, the mode and the gap — also under
    `python -O`, which drops JAX's assert."""
    ref = _fixture(tmp_path)
    runs = str(tmp_path / "runs")
    if fault == "anchor_ref_missing":
        gone = ref / "comparison_results_neg_int_strength_p3_harmonic" / "raw_comparison_results.csv"
        gone.unlink()
        with pytest.raises(FileNotFoundError, match=str(gone)):
            tg.build_table(runs, str(ref))
        assert "neg_p3_harmonic" in tr.build_table(runs, str(ref))   # its own file
    elif fault == "parity_ref_missing":
        gone = ref / "comparison_results_p3_gaussian" / "paper_style_results.csv"
        gone.unlink()
        with pytest.raises(FileNotFoundError, match=str(gone)):
            tr.build_table(runs, str(ref))
        assert "p3_gaussian" in tg.build_table(runs, str(ref))
    elif fault == "mu_ref_shifted":
        _shift_mu_ref(tmp_path)
        with pytest.raises(ValueError, match=r"p3_harmonic mode 1: .* 1\.020e-04 off"):
            tg.build_table(runs, str(ref))
    else:
        _shift_mu_ref(tmp_path)
        out = subprocess.run(
            [sys.executable, "-O", "-m", "gpe_tpu_torch.experiments.gamma0_anchor",
             "--ref-root", str(ref), "--runs", runs, "--out", str(tmp_path / "o")],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "p3_harmonic mode 1" in out.stderr, out.stderr
        assert not (tmp_path / "o" / "gamma0_anchor.md").exists()


def test_reports_hold_the_committed_tables():
    """On the committed runs/ and a reference tree quoting the committed
    tables' reference cells: every "ours" cell of parity.md (33 rows, the
    whole file byte-equal) and of gamma0_anchor.md but its stale Gaussian
    mode-0 row (recomputed 1.39e-06 from the CSV written after the table,
    against 2.13e-06 committed)."""
    res = report_check.check_committed(str(ROOT / "runs"))
    assert res["parity"]["rows"] == res["parity"]["equal"] == 33
    assert res["parity"]["identical"]
    anchor = res["gamma0_anchor"]
    assert (anchor["rows"], anchor["equal"]) == (33, 32)
    assert [d["row"] for d in anchor["differ"]] == [["p3_gaussian", "0"]]
    assert anchor["differ"][0]["built"][2:] == ["10.741232 (f64 FDM)", "1.39e-06"]
    assert anchor["differ"][0]["committed"][2:] == ["10.741233 (f64 FDM)", "2.13e-06"]
    assert res["ok"]


def test_report_check_fails_on_a_changed_ours_cell(tmp_path):
    """report_check is not blind: one of our committed cells changed (the
    harmonic family's mode-0 PL-PINN-R abs_err) breaks a parity row and
    `ok`."""
    import shutil

    runs = tmp_path / "runs"
    shutil.copytree(ROOT / "runs" / "reference_parity", runs / "reference_parity")
    for fam in tr.FAMILIES:
        src = ROOT / "runs" / f"comparison_results_{fam}"
        dst = runs / f"comparison_results_{fam}"
        dst.mkdir(parents=True)
        for name in ("paper_style_results.csv", "raw_comparison_results.csv"):
            shutil.copy(src / name, dst / name)
    ramp = Path("comparison_results_p3_gravity_well") / "ramp025" / "summary.json"
    (runs / ramp).parent.mkdir(parents=True)
    shutil.copy(ROOT / "runs" / ramp, runs / ramp)
    assert report_check.check_committed(str(runs))["ok"]
    path = runs / "comparison_results_p3_harmonic" / "paper_style_results.csv"
    path.write_text(path.read_text().replace("Mode 0,PL-PINN-R,2.60e-05",
                                             "Mode 0,PL-PINN-R,2.61e-05"))
    res = report_check.check_committed(str(runs))
    assert not res["ok"] and res["parity"]["equal"] == 32
    assert res["parity"]["differ"][0]["row"] == ["p3_harmonic", "0"]
