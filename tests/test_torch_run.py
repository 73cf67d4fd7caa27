"""The port's experiment runner (`gpe_tpu_torch.experiments.run`, the
`plpinn` branch of gpe_tpu/experiments/run.py) and the float64 endgame
(`polish_checkpoints`, `polish_x64`, `lm_polish_x64`, `_eval_mu_x64`)
against the JAX package, on the CPU at small sizes.

Tolerances: the oracle μ_ref relative ≤ 1e-9 (the same imaginary-time
oracle on the same grid, float64 on both sides). The f64 LM endgame: the
same λ decisions, the loss history relative ≤ 1e-6 and the params within
1e-6 — its residuals and Jacobian products agree to ~1e-15, but CG
amplifies that by the normal matrix's condition number (its solutions
differ by 6e-7 after 15 iterations; the histories by 7.6e-8, the params by
1.5e-8 on these inputs); the reported μ within 1e-6 relative, because the
JAX package also reduces the loss sums in f32 under x64 (losses/gpe.py
`_red`), the port in f64 (1.2e-7 here).
"""
import json
import math
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.train import gauss_newton as jgn  # noqa: E402
from gpe_tpu.train import plpinn as jpl  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu.validate.imaginary_time import imaginary_time_gpe as j_itime  # noqa: E402
from gpe_tpu_torch.experiments import run  # noqa: E402
from gpe_tpu_torch.experiments.configs import EXPERIMENTS  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import gauss_newton as tgn  # noqa: E402
from gpe_tpu_torch.train import plpinn as tpl  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the keys of the JAX runner's plpinn record (gpe_tpu/experiments/run.py:185-188)
JAX_RECORD = {"experiment", "mu_table_tail", "wall_s"}


def _tree(path: Path):
    return sorted((str(p.relative_to(path)), p.stat().st_mtime_ns)
                  for p in path.rglob("*"))


def test_run_main_linear_1d_sanity_on_the_cpu(tmp_path, monkeypatch, capsys):
    """--cpu, a tiny schedule, the default --out (runs_torch under the
    working directory): the JAX record's keys, a summary.json, the bundle
    loaded on a second call, and nothing written under the repo's runs/."""
    runs_before = _tree(ROOT / "runs")
    monkeypatch.chdir(tmp_path)
    argv = ["linear_1d_sanity", "--cpu", "--epochs", "30", "--pretrain", "40"]
    assert run.main(argv + ["--train"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert JAX_RECORD | {"plot"} <= set(rec) <= JAX_RECORD | {"seconds", "plot"}
    assert rec["plot"] == ["mu_vs_gamma.png", "loss_history.png", "epochs_heatmap.png",
                           "wavefunctions.png"]
    assert rec["experiment"] == "linear_1d_sanity"
    gamma, mu = rec["mu_table_tail"]["0"]
    assert gamma == 0.0 and abs(mu - 0.5) < 2e-2
    assert set(rec["seconds"]) == {"pretrain", "fit", "lm"}
    out = tmp_path / "runs_torch" / "linear_1d_sanity"
    assert json.loads((out / "summary.json").read_text()) == rec
    assert (out / "bundle.pkl").exists() and not (tmp_path / "runs").exists()
    assert run.main(argv) == 0                      # loads the bundle, no training
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(again) == JAX_RECORD | {"plot"}
    assert again["mu_table_tail"] == rec["mu_table_tail"]
    assert _tree(ROOT / "runs") == runs_before


def test_run_main_refuses_what_the_port_lacks(tmp_path, monkeypatch):
    """A `numeric:` basis that no one registered raises KeyError through the
    runner, naming `register_numeric_basis`, as the JAX package does."""
    cfg = EXPERIMENTS["linear_1d_sanity"]
    monkeypatch.setitem(EXPERIMENTS, "linear_1d_sanity",
                        replace(cfg, spec=replace(cfg.spec, basis="numeric:never_registered")))
    with pytest.raises(KeyError, match="register_numeric_basis"):
        run.main(["linear_1d_sanity", "--cpu", "--train", "--epochs", "2", "--pretrain",
                  "2", "--out", str(tmp_path)])
    assert run.main(["--list", "gpe2d_ground_state"]) == 0


def test_run_main_scores_2d_against_the_oracle(tmp_path, monkeypatch, capsys):
    """gpe2d_ground_state cut to 12² points and [2,16,16,1], two LM steps,
    and the oracle on a 40² grid: the record carries the JAX record's
    lm_polished keys, and μ_ref is the JAX oracle's on that grid."""
    cfg = EXPERIMENTS["gpe2d_ground_state"]
    small = replace(cfg, spec=replace(cfg.spec, n_points=12, layers=(2, 16, 16, 1)))
    monkeypatch.setitem(EXPERIMENTS, "gpe2d_ground_state", small)
    monkeypatch.setattr(run, "ORACLE_GRID", 40)
    assert run.main(["gpe2d_ground_state", "--cpu", "--train", "--epochs", "20",
                     "--pretrain", "30", "--gammas", "0", "5", "--lm-steps", "2",
                     "--out", str(tmp_path)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == JAX_RECORD | {"lm_polished", "seconds", "plot"}
    pol = rec["lm_polished"]["0"]
    assert set(pol) == {"gamma", "mu", "steps", "scale", "mu_ref", "mu_abs_err"}
    assert pol["gamma"] == 5.0 and pol["steps"] == 2
    x1 = np.linspace(cfg.spec.lb, cfg.spec.ub, 40)
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    mu_ref, _ = j_itime(0.5 * (X**2 + Y**2), x1[1] - x1[0], 5.0, kinetic=0.5, p=3.0,
                        tau=2e-3, richardson=2)
    assert abs(pol["mu_ref"] - mu_ref) <= 1e-9 * abs(mu_ref)
    assert pol["mu_abs_err"] == abs(pol["mu"] - pol["mu_ref"])
    assert set(rec["seconds"]) == {"pretrain", "fit", "lm", "oracle"}


SPEC_1D = dict(dim=1, n_points=64, layers=(1, 12, 12, 1), lb=-8.0, ub=8.0,
               potential="harmonic", nonlinearity="abs_power", basis="hermite",
               activation="shifted_tanh")


def test_polish_x64_matches_jax():
    rng = np.random.default_rng(4)
    p = [(0.5 * rng.standard_normal((i, o)), 0.1 * rng.standard_normal(o))
         for i, o in zip(SPEC_1D["layers"][:-1], SPEC_1D["layers"][1:])]
    gamma, scale = 2.0, 0.05
    jspec, tspec = jprob.GPESpec(**SPEC_1D), tprob.GPESpec(**SPEC_1D)
    jbatch = jprob.make_batch(jspec, 0)
    jres = jgn.lm_polish_x64(jgn.make_gpe_residual_fn(jspec),
                             tuple((jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32))
                                   for w, b in p), jbatch, gamma, scale, steps=4,
                             cg_iters=15)
    jmu = jpl._eval_mu_x64(jprob.make_loss_fn(jspec), jres.params, jbatch, gamma, scale)

    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}   # the same f32 inputs
    tres = tgn.lm_polish_x64(tgn.make_gpe_residual_fn(tspec),
                             params_from_numpy(p, device="cpu"), tbatch, gamma, scale,
                             steps=4, cg_iters=15)
    tmu = tpl._eval_mu_x64(tprob.make_loss_fn(tspec), tres.params, tbatch, gamma, scale)
    assert all(t.dtype == torch.float64 for pair in tres.params for t in pair)
    np.testing.assert_array_equal(tres.lam_history, np.asarray(jres.lam_history))
    np.testing.assert_allclose(tres.loss_history, np.asarray(jres.loss_history), rtol=1e-6)
    for (tw, tb), (jw, jb) in zip(tres.params, jres.params):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    assert abs(tmu - jmu) <= 1e-6 * abs(jmu), (tmu, jmu)
    assert abs(tmu - jmu) <= 1e-6 * abs(jmu), (tmu, jmu)


@pytest.mark.parametrize("x64", [False, True])
def test_train_plpinn_polish_checkpoints(x64):
    """polish_checkpoints (f32 LM, then the f64 endgame with polish_x64) on
    a copy of the best params mid-ramp: μ per checkpoint γ in
    polished[mode]["by_gamma"], the ramp itself unpolished."""
    spec = tprob.GPESpec(**SPEC_1D)
    run_kw = dict(epochs=40, pretrain_epochs=60, check_every=20, rebase=True,
                  lm_steps=2, lm_cg_iters=8, device="cpu")
    plain = tpl.train_plpinn(spec, (0.0, 1.0, 2.0), **run_kw)
    res = tpl.train_plpinn(spec, (0.0, 1.0, 2.0), polish_checkpoints=(1.0, 2.0),
                           polish_x64=x64, polish_x64_steps=2, **run_kw)
    assert res.mu_table == plain.mu_table
    by_gamma = res.polished[0]["by_gamma"]
    assert set(by_gamma) == {1.0, 2.0}
    for g, mu in res.mu_table[0][1:]:
        assert math.isfinite(by_gamma[g]) and abs(by_gamma[g] - mu) < 5e-2

