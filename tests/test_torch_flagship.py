"""Port parity of the spectral-flow solver's float32 runs and its `report`,
and of the 2D flagship driver (`experiments/gpe2d_flagship.py`), against
the JAX package on the CPU (small sizes, and the JAX artifact at 224²).

Tolerances. In float32 the grid μ history at rtol 1e-5, the fit history at
1e-4 (Adam trajectories of other summation orders, measured 9.5e-7 and
1.4e-5), μ_grid at 1e-6. `report` on small random params at rtol 1e-5.
The JAX flagship artifact through `report` within 1e-6 of the JAX
package's report arithmetic (f32, matmul precision "highest"; measured
4.8e-7, one ulp of 5.76). The flagship's oracle μ_ref at rtol 1e-9 (the
same float64 oracle on the same grid).
"""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.ops.rayleigh import hamiltonian_apply as j_ham  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu.validate.imaginary_time import imaginary_time_gpe as j_itime  # noqa: E402
from gpe_tpu_torch.experiments import gpe2d_flagship as tflag  # noqa: E402
from gpe_tpu_torch.io import load_params  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402
from gpe_tpu_torch.train import spectral_flow as tsf  # noqa: E402
from test_torch_spectral_flow import BC, CUT, FLAGSHIP, _both, _init, _kw  # noqa: E402

ORACLE_STEPS = 100


@pytest.mark.parametrize("case", ["2d_periodic", "1d_dirichlet_box"])
def test_solver_matches_jax_f32(case):
    jr, tr = _both(_kw(case), False, bc=BC[case], **CUT)
    np.testing.assert_allclose(tr.mu_history[:-1], jr.mu_history[:-1], rtol=1e-5)
    np.testing.assert_allclose(tr.fit_history[:-1], jr.fit_history[:-1], rtol=1e-4)
    np.testing.assert_allclose(tr.mu_grid, jr.mu_grid, rtol=1e-6)


def _j_report(params, spec, batch, gamma):
    """JAX's `report` arithmetic (gpe_tpu/train/spectral_flow.py:200-212)."""
    dx = (spec.ub - spec.lb) / (spec.n_points - 1)
    n = jmlp.mlp_vgl(params, batch["x"], spec.activation)
    norm = jnp.sqrt(jnp.sum(n.value ** 2) * dx ** spec.dim + 1e-30)
    u, lap = n.value / norm, n.lap / norm
    hu = j_ham(u, lap, batch["V"], jnp.float32(gamma), spec.p, spec.kinetic,
               spec.nonlinearity)
    mu = jnp.sum(u * hu) / (jnp.sum(u * u) + 1e-12)
    return float(mu), float(jnp.mean((hu - mu * u) ** 2))


def test_report_matches_jax_small():
    kw = _kw("2d_periodic")
    init = _init(kw["layers"])
    jspec, tspec = jprob.GPESpec(**kw), tprob.GPESpec(**kw)
    want = _j_report([(jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32))
                      for w, b in init], jspec, jprob.make_batch(jspec, 0), 7.0)
    mu, pde = tsf.make_spectral_flow_solver(tspec).report(
        params_from_numpy(init, device="cpu"), tprob.make_batch(tspec, 0, device="cpu"),
        torch.tensor(7.0))
    np.testing.assert_allclose([float(mu), float(pde)], want, rtol=1e-5)


def test_2d_flagship_artifact_through_report():
    """runs/gpe2d_flagship/params.pkl at γ = 100 on the 224² grid: the port's
    report against the JAX package's report arithmetic, and chip_smoke.py's
    stored constant against this JAX value."""
    import chip_smoke

    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        p = load_params("runs/gpe2d_flagship/params.pkl")
        jspec = jprob.GPESpec(**FLAGSHIP)
        want, _ = _j_report(jax.tree.map(jnp.asarray, p), jspec,
                            jprob.make_batch(jspec, 0), 100.0)
    finally:
        jax.config.update("jax_default_matmul_precision", None)
    tspec = tprob.GPESpec(**FLAGSHIP)
    mu, _ = tsf.make_spectral_flow_solver(tspec).report(
        params_from_numpy(p, device="cpu"), tprob.make_batch(tspec, 0, device="cpu"),
        torch.tensor(100.0))
    assert abs(float(mu) - want) <= 1e-6
    assert chip_smoke.FLAGSHIP_MU["gpe2d_flagship"] == pytest.approx(want, rel=1e-7)


def test_psi_errors_match_jax():
    kw = dict(FLAGSHIP, n_points=16, layers=(2, 16, 16, 1))
    init = _init(kw["layers"])
    x1 = np.linspace(-8, 8, 40)
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    ref = np.exp(-0.5 * (X ** 2 + Y ** 2)) / np.sqrt(np.pi)
    from gpe_tpu.experiments.gpe2d_flagship import psi_errors as j_psi

    want = j_psi([(jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32))
                  for w, b in init], jprob.GPESpec(**kw), x1, ref)
    got = tflag.psi_errors(params_from_numpy(init, device="cpu"), tprob.GPESpec(**kw),
                           x1, torch.as_tensor(ref))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _cut(monkeypatch, module, name, **over):
    """Replace module.name, which the drivers import when they run, by the
    same function called with the keyword arguments `over` (the drivers'
    schedules cut to a CPU test's depth)."""
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: fn(*a, **{**kw, **over}))


def test_flagship_main_at_tiny_size(tmp_path, monkeypatch, capsys):
    """The driver at --n 16 --width 16 (its schedule cut through the
    functions it calls, the 384² oracle to ORACLE_STEPS steps a Richardson
    level): JAX's summary keys, params.pkl, the oracle μ_ref of JAX's
    imaginary_time_gpe on the same grid with the same steps, and μ_grid
    within 1e-2 of JAX's converged oracle on 48²."""
    from gpe_tpu_torch.train import pretrain
    from gpe_tpu_torch.validate import imaginary_time

    _cut(monkeypatch, pretrain, "pretrain_to_base", epochs=50, lbfgs_steps=5)
    _cut(monkeypatch, tsf, "make_spectral_flow_solver", final_inner_steps=30,
         final_lbfgs_steps=5, polish_steps=1)
    itime = imaginary_time.imaginary_time_gpe
    # the driver's call gets the cut; the Richardson levels' own calls
    # (all arguments positional) keep theirs: 2× and 4× ORACLE_STEPS
    monkeypatch.setattr(imaginary_time, "imaginary_time_gpe", lambda *a, **kw: itime(
        *a, **(kw if len(a) > 3 else {**kw, "steps": ORACLE_STEPS})))
    assert tflag.main(["--cpu", "--n", "16", "--width", "16", "--gammas", "2", "5",
                       "--outer", "2", "--inner", "3", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "summary.json").read_text())
    assert set(rec) == {"ramp", "summary"} and (tmp_path / "params.pkl").exists()
    jax_keys = {"config", "n_points", "gamma", "mu_net", "mu_grid", "mu_ref", "abs_err_net",
                "abs_err_grid", "psi_l2_err", "psi_max_err", "target", "total_wall_s"}
    s = rec["summary"]
    assert set(s) == jax_keys | {"seconds", "device", "plot"} and s["n_points"] == 256
    assert s["plot"] == ["flagship_solution.png"]
    assert [r["gamma"] for r in rec["ramp"]] == [2.0, 5.0]
    assert all({"gamma", "mu_net", "mu_grid", "pde_loss", "wall_s"} <= set(r)
               for r in rec["ramp"])
    x1 = np.linspace(-8, 8, 384)
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    mu_ref, _ = j_itime(0.5 * (X ** 2 + Y ** 2), x1[1] - x1[0], 5.0, kinetic=0.5,
                        tau=2e-3, richardson=True, steps=ORACLE_STEPS)
    np.testing.assert_allclose(s["mu_ref"], mu_ref, rtol=1e-9)
    assert s["abs_err_grid"] == abs(s["mu_grid"] - s["mu_ref"])
    # the endgame's μ_grid against JAX's converged oracle on 48²
    x1 = np.linspace(-8, 8, 48)
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    mu48, _ = j_itime(0.5 * (X ** 2 + Y ** 2), x1[1] - x1[0], 5.0, kinetic=0.5,
                      tau=2e-3, richardson=True)
    assert abs(s["mu_grid"] - mu48) < 1e-2 and np.isfinite(s["mu_net"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == s
