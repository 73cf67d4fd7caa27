"""Port parity in three dimensions beyond tests/test_3d.py: the GPE loss and
its gradients in float64, the spectral-flow solver at 8³ (periodic and
Dirichlet), the JAX 3D artifact through `report`, and the 3D flagship
driver (`experiments/gpe3d_ground_state.py`: the oracle ladder and its
cache, ψ errors, the CPU smoke of its docstring, scaled down).

Tolerances: the loss in f64 at rtol 1e-6 / gradients normalised 1e-5 (the
JAX package reduces the loss sums in f32 even under x64, losses/gpe.py
`_red`); the flow solver in f64 at 1e-9 (tests/test_torch_spectral_flow.py);
the artifact's μ within 1e-6 of the JAX package's report arithmetic (f32,
matmul precision "highest"; measured 7.2e-7, 1.5 ulps of 3.71); the
oracle ladder's μ at rtol 1e-10 and ψ at 1e-9 (float64 on both sides), its
grid-error bound at rtol 1e-6 (a difference of two such μ).
"""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.experiments import gpe3d_ground_state as jflag3  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.experiments import gpe3d_ground_state as tflag3  # noqa: E402
from gpe_tpu_torch.io import load_params  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402
from gpe_tpu_torch.train import spectral_flow as tsf  # noqa: E402
from gpe_tpu_torch.train.loop import value_and_grad  # noqa: E402
from test_torch_3d import FLAGSHIP3, _spec3d  # noqa: E402
from test_torch_flagship import _cut  # noqa: E402
from test_torch_spectral_flow import F64_RTOL, _both, _init  # noqa: E402


@pytest.mark.parametrize("perturbation", [True, False])
def test_loss_and_grads_3d_match_jax_f64(perturbation):
    kw = _spec3d(use_perturbation=perturbation)
    init = _init(kw["layers"], seed=2)
    with jax.enable_x64(True):
        jspec = jprob.GPESpec(**kw, dtype=jnp.float64)
        jp = [(jnp.asarray(w), jnp.asarray(b)) for w, b in init]
        (jt, ja), jg = jax.value_and_grad(jprob.make_loss_fn(jspec), has_aux=True)(
            jp, jprob.make_batch(jspec, 0), jnp.float64(5.0), jnp.float64(0.01))
        jt, jmu = float(jt), float(ja["mu"])
        jg = [np.asarray(g) for g in jax.tree.leaves(jg)]
    tspec = tprob.GPESpec(**kw, dtype=torch.float64)
    (tt, ta), tg = value_and_grad(tprob.make_loss_fn(tspec))(
        params_from_numpy(init, device="cpu", dtype=torch.float64),
        tprob.make_batch(tspec, 0, device="cpu"), torch.tensor(5.0, dtype=torch.float64),
        torch.tensor(0.01, dtype=torch.float64))
    np.testing.assert_allclose(float(tt), jt, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(ta["mu"]), jmu, rtol=1e-6)
    for got, want in zip([t for pair in tg for t in pair], jg):
        s = np.abs(want).max() + 1e-30
        np.testing.assert_allclose(got.numpy() / s, want / s, rtol=0, atol=1e-5)


@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
def test_spectral_flow_solver_3d_matches_jax_f64(bc):
    kw = dict(_spec3d(use_perturbation=False), layers=(3, 8, 8, 1))
    jr, tr = _both(kw, True, bc=bc, outer_steps=2, inner_steps=3, final_inner_steps=10,
                   final_lbfgs_steps=3, endgame_steps=1000)
    np.testing.assert_allclose(tr.mu_history, jr.mu_history, rtol=F64_RTOL)
    np.testing.assert_allclose(tr.fit_history, jr.fit_history, rtol=F64_RTOL)
    np.testing.assert_allclose(tr.target, jr.target, rtol=0, atol=F64_RTOL)
    np.testing.assert_allclose(tr.mu, jr.mu, rtol=F64_RTOL)


def test_3d_artifact_through_report():
    """runs/gpe3d_ground_state/params.pkl at γ = 100 on the 36³ grid: the
    port's report against the JAX package's report arithmetic, and
    chip_smoke.py's stored constant against this JAX value."""
    import chip_smoke
    from test_torch_flagship import _j_report

    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        p = load_params("runs/gpe3d_ground_state/params.pkl")
        jspec = jprob.GPESpec(**FLAGSHIP3)
        want, _ = _j_report(jax.tree.map(jnp.asarray, p), jspec,
                            jprob.make_batch(jspec, 0), 100.0)
    finally:
        jax.config.update("jax_default_matmul_precision", None)
    tspec = tprob.GPESpec(**FLAGSHIP3)
    mu, _ = tsf.make_spectral_flow_solver(tspec).report(
        params_from_numpy(p, device="cpu"), tprob.make_batch(tspec, 0, device="cpu"),
        torch.tensor(100.0))
    assert abs(float(mu) - want) <= 1e-6
    assert chip_smoke.FLAGSHIP_MU["gpe3d_ground_state"] == pytest.approx(want, rel=1e-7)


def test_oracle_ladder_matches_jax_and_resumes(tmp_path):
    """_oracle's γ ladder (10³, confirmed on 12³) against the JAX driver's,
    written to its cache after every rung; a second call reads the cache."""
    args = ([0.0, 5.0], 10, -6.0, 6.0)
    want = jflag3._oracle(*args, str(tmp_path / "jax.npz"), confirm_n=12, verbose=False)
    got = tflag3._oracle(*args, str(tmp_path / "port.npz"), confirm_n=12, verbose=False,
                         device="cpu")
    assert set(got[0]) == set(want[0]) == {0.0, 5.0}
    for g in want[0]:
        np.testing.assert_allclose(got[0][g], want[0][g], rtol=1e-10)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-12)
    again = tflag3._oracle(*args, str(tmp_path / "port.npz"), confirm_n=12, verbose=False,
                           device="cpu")
    assert again[0] == got[0] and np.array_equal(again[1], got[1])


def test_psi_errors_3d_match_jax():
    rng = np.random.default_rng(4)
    x1 = np.linspace(-6.0, 6.0, 9)
    a, b = rng.normal(size=9 ** 3), rng.normal(size=(9, 9, 9))
    np.testing.assert_allclose(tflag3.psi_errors_3d(a, x1, b),
                               jflag3.psi_errors_3d(a, x1, b), rtol=1e-12)


def test_3d_driver_cpu_smoke(tmp_path, monkeypatch, capsys):
    """The driver's CPU smoke (its docstring's arguments, scaled down; the
    schedule cut through the functions it calls): the JAX summary's keys,
    params.pkl, the oracle cache, and μ_ref of the oracle ladder."""
    from gpe_tpu_torch.train import pretrain

    _cut(monkeypatch, pretrain, "pretrain_to_base", epochs=50, lbfgs_steps=5)
    _cut(monkeypatch, tsf, "make_spectral_flow_solver", final_inner_steps=30,
         final_lbfgs_steps=5)
    assert tflag3.main(["--cpu", "--n", "8", "--width", "16", "--outer", "2", "--inner",
                        "3", "--gammas", "0", "5", "--oracle-n", "12",
                        "--oracle-confirm-n", "16", "--lm-steps", "1",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "summary.json").read_text())
    jax_keys = {"config", "ramp", "mu_final", "mu_grid_final", "mu_ref_final",
                "abs_err_final", "abs_err_grid_final", "oracle_grid_err_bound",
                "mu_tf_final", "psi_l2_err", "psi_max_err", "wall_s"}
    assert set(rec) == jax_keys | {"seconds", "device", "plot"}
    assert rec["plot"] == ["midplane_z0.png"]
    assert [r["gamma"] for r in rec["ramp"]] == [0.0, 5.0]
    assert (tmp_path / "params.pkl").exists() and (tmp_path / "oracle_cache.npz").exists()
    cache = np.load(tmp_path / "oracle_cache.npz")
    np.testing.assert_allclose(rec["mu_ref_final"], cache["mus"][-1], rtol=0)
    assert all(np.isfinite(rec[k]) for k in ("mu_final", "psi_l2_err", "mu_tf_final"))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
