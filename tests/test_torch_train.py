"""Port parity: the loss, the fit loop, pretraining, LM and PL-PINN against
the JAX package (CPU, small sizes).

Tolerances: loss values in f64 at rtol 1e-6 / atol 1e-7 and gradients at
normalised atol 1e-5 (the JAX package reduces the loss sums in f32 even
under x64, losses/gpe.py `_red`, so f32 rounding of the sums is the floor);
f32 training
trajectories (fit, LM) at the stated looser bounds, since the two sides
take the same steps with other summation orders. The slice-level runs start
from different random inits on each side (JAX PRNG vs torch.Generator), so
they are held to the exact linear eigenvalue, not to each other's digits.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.train import gauss_newton as jgn  # noqa: E402
from gpe_tpu.train import loop as jloop  # noqa: E402
from gpe_tpu.train import plpinn as jpl  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.experiments.configs import EXPERIMENTS  # noqa: E402
from gpe_tpu_torch.models.mlp import init_mlp, mlp_apply, params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import gauss_newton as tgn  # noqa: E402
from gpe_tpu_torch.train import loop as tloop  # noqa: E402
from gpe_tpu_torch.train import plpinn as tpl  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402
from gpe_tpu_torch.train.pretrain import pretrain_to_base  # noqa: E402
from gpe_tpu_torch.train.schedules import (cosine_warm_restarts,  # noqa: E402
                                           scale_by_loss_as_step)

SPEC_1D = dict(dim=1, n_points=256, layers=(1, 32, 32, 1), lb=-8.0, ub=8.0,
               potential="harmonic", nonlinearity="power", basis="hermite",
               activation="shifted_tanh")
SPEC_2D = dict(dim=2, n_points=14, layers=(2, 24, 24, 1), lb=-8.0, ub=8.0,
               potential="harmonic", potential_kwargs=(("a", 0.5),), kinetic=0.5,
               nonlinearity="abs_power", basis="hermite", activation="shifted_tanh")


def _jax_params(layers, seed=0):
    return jmlp.init_mlp(jax.random.PRNGKey(seed), layers)


def _np(params):
    return [(np.array(w), np.array(b)) for w, b in params]


@pytest.mark.parametrize("kw", [SPEC_1D, SPEC_2D,
                                dict(SPEC_2D, use_perturbation=False,
                                     activation="tanh")])
def test_loss_and_autograd_grads_match_jax_f64(kw):
    gamma, scale = 4.0, 0.03
    with jax.enable_x64(True):
        jspec = jprob.GPESpec(**kw, dtype=jnp.float64)
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                               _jax_params(jspec.layers))
        jbatch = jprob.make_batch(jspec, 0)
        (jt, jaux), jg = jax.value_and_grad(jprob.make_loss_fn(jspec), has_aux=True)(
            jparams, jbatch, gamma, scale)
        jt = float(jt)
        jaux = {k: float(v) for k, v in jaux.items()}
        jg = _np(jg)
        np_params = _np(jparams)
    tspec = tprob.GPESpec(**kw, dtype=torch.float64)
    tbatch = tprob.make_batch(tspec, 0, device="cpu")
    (tt, taux), tg = tloop.value_and_grad(tprob.make_loss_fn(tspec))(
        params_from_numpy(np_params, device="cpu", dtype=torch.float64), tbatch, gamma, scale)
    np.testing.assert_allclose(float(tt), jt, rtol=1e-6)
    for k in ("pde", "boundary", "norm", "mu"):
        np.testing.assert_allclose(float(taux[k]), jaux[k], rtol=1e-6, atol=1e-7)
    for (gw, gb), (ww, wb) in zip(tg, jg):
        for a, b in ((gw.numpy(), ww), (gb.numpy(), wb)):
            np.testing.assert_allclose(a / np.max(np.abs(b)), b / np.max(np.abs(b)),
                                       atol=1e-5)


def test_schedules_match_jax():
    from gpe_tpu.train.schedules import cosine_warm_restarts as jcwr
    js, ts = jcwr(1e-3, 200, 2, 1e-6), cosine_warm_restarts(1e-3, 200, 2, 1e-6)
    steps = np.array([0.0, 1e-4, 0.5, 50.0, 199.0, 200.0, 450.0, 600.0, 1234.5],
                     np.float32)
    want = np.asarray(js(jnp.asarray(steps)))
    got = ts(torch.as_tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    apply = scale_by_loss_as_step(ts)
    (u,) = apply([torch.ones(3)], torch.tensor(150.0))
    np.testing.assert_allclose(u.numpy(), -float(ts(torch.tensor(150.0))), rtol=1e-7)


def _fit_setup():
    jspec, tspec = jprob.GPESpec(**SPEC_1D), tprob.GPESpec(**SPEC_1D)
    jparams = _jax_params(jspec.layers, 1)
    jbatch = jprob.make_batch(jspec, 0)
    tbatch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    return jspec, tspec, jparams, params_from_numpy(_np(jparams), device="cpu"), jbatch, tbatch


def test_fit_matches_jax_fit_with_the_ramp_optimizer():
    """20 steps (chunks of 8 and a tail of 4), the same params and batch:
    f32 loss histories agree to 1e-4 relative."""
    jspec, tspec, jparams, tparams, jbatch, tbatch = _fit_setup()
    kw = dict(epochs=20, tol=-1.0, patience=10 ** 9, check_every=8)
    jres = jloop.fit(jprob.make_loss_fn(jspec), jpl.ramp_optimizer(1e-3), jparams,
                     jbatch, 2.0, 0.05, **kw)
    tres = tloop.fit(tprob.make_loss_fn(tspec), tpl.ramp_optimizer(1e-3), tparams,
                     tbatch, 2.0, 0.05, **kw)
    assert tres.epochs_run == jres.epochs_run == 20
    np.testing.assert_allclose(tres.loss_history, jres.loss_history, rtol=1e-4)
    np.testing.assert_allclose(tres.mu_history, jres.mu_history, rtol=1e-5)
    np.testing.assert_allclose(tres.best_loss, jres.best_loss, rtol=1e-4)
    np.testing.assert_allclose(tres.mu_best, jres.mu_best, rtol=1e-5)
    for (tw, tb), (jw, jb) in zip(tres.final_params, jres.final_params):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


def test_fit_early_stop_matches_jax():
    """tol between two early losses: both loops stop at the same epoch,
    truncate their histories there and restore the same best params."""
    jspec, tspec, jparams, tparams, jbatch, tbatch = _fit_setup()
    ref = jloop.fit(jprob.make_loss_fn(jspec), jpl.ramp_optimizer(1e-3), jparams,
                    jbatch, 2.0, 0.05, epochs=20, tol=-1.0, patience=10 ** 9,
                    check_every=8)
    h = ref.loss_history
    k = int(np.argmax(np.diff(h) < 0) + 1)          # first loss below its predecessor
    tol = float(0.5 * (h[k - 1] + h[k]))
    want = int(np.argmax(h <= tol))
    kw = dict(epochs=20, tol=tol, patience=10 ** 9, check_every=8)
    jres = jloop.fit(jprob.make_loss_fn(jspec), jpl.ramp_optimizer(1e-3), jparams,
                     jbatch, 2.0, 0.05, **kw)
    tres = tloop.fit(tprob.make_loss_fn(tspec), tpl.ramp_optimizer(1e-3), tparams,
                     tbatch, 2.0, 0.05, **kw)
    assert tres.epochs_run == jres.epochs_run == want
    assert len(tres.loss_history) == len(jres.loss_history) == max(want, 1)
    for (tw, tb), (jw, jb) in zip(tres.params, jres.params):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


def test_fit_patience_stop_restores_best():
    """With the loss pushed up by a huge step, patience stops the loop and
    the returned params are the best (initial) ones, masked steps included."""
    _, tspec, _, tparams, _, tbatch = _fit_setup()
    loss_fn = tprob.make_loss_fn(tspec)
    opt = tpl.ramp_optimizer(1e-3)
    opt.step = lambda u, value: torch._foreach_mul(u, -0.5)   # far too large
    res = tloop.fit(loss_fn, opt, tparams, tbatch, 2.0, 0.05, epochs=40,
                    tol=-1.0, patience=3, check_every=16)
    assert res.epochs_run < 16 and len(res.loss_history) == res.epochs_run
    best = int(np.argmin(res.loss_history))
    np.testing.assert_allclose(res.best_loss, res.loss_history[best], rtol=1e-6)
    total, _ = loss_fn(res.params, tbatch, 2.0, 0.05)
    np.testing.assert_allclose(float(total), res.best_loss, rtol=1e-5)


def test_pretrain_fits_base():
    spec = tprob.GPESpec(n_points=512)
    batch = tprob.make_batch(spec, 0, device="cpu")
    target = tprob.base_triple(spec, 0, batch["x"]).value
    params = init_mlp(spec.layers, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    params, mse = pretrain_to_base(params, batch["x"], target, spec.activation,
                                   epochs=600, lbfgs_steps=30)
    assert mse < 1e-4
    np.testing.assert_allclose(
        float(torch.mean((mlp_apply(params, batch["x"], spec.activation) - target) ** 2)),
        mse, rtol=1e-6)


def test_lm_residual_matches_loss_and_jax_and_lowers_it():
    kw = dict(SPEC_2D)
    jspec = jprob.GPESpec(**kw)
    jparams = _jax_params(jspec.layers, 2)
    jbatch = jprob.make_batch(jspec, 0)
    j_r = np.asarray(jgn.make_gpe_residual_fn(jspec)(jparams, jbatch, 3.0, 0.05))
    j_lm = jgn.make_lm_solver(jgn.make_gpe_residual_fn(jspec), jparams, steps=3,
                              cg_iters=20)(jparams, jbatch, 3.0, 0.05)

    tspec64 = tprob.GPESpec(**kw, dtype=torch.float64)
    b64 = tprob.make_batch(tspec64, 0, device="cpu")
    p64 = params_from_numpy(_np(jparams), device="cpu", dtype=torch.float64)
    r = tgn.make_gpe_residual_fn(tspec64)(p64, b64, 3.0, 0.05)
    total, _ = tprob.make_loss_fn(tspec64)(p64, b64, 3.0, 0.05)
    np.testing.assert_allclose(float(torch.sum(r * r)), float(total), rtol=1e-12)

    tspec = tprob.GPESpec(**kw)
    tbatch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    tparams = params_from_numpy(_np(jparams), device="cpu")
    rfn = tgn.make_gpe_residual_fn(tspec)
    np.testing.assert_allclose(rfn(tparams, tbatch, 3.0, 0.05).numpy(), j_r,
                               rtol=1e-4, atol=1e-6)
    res = tgn.make_lm_solver(rfn, tparams, steps=3, cg_iters=20)(
        tparams, tbatch, 3.0, 0.05)
    r0 = rfn(tparams, tbatch, 3.0, 0.05)
    assert res.loss < float(torch.sum(r0 * r0))
    # three f32 LM steps from the same point on both sides: same damping
    # decisions, losses within 5% (CG in f32 amplifies rounding differences)
    np.testing.assert_allclose(res.lam_history, np.asarray(j_lm.lam_history), rtol=1e-6)
    np.testing.assert_allclose(res.loss_history, np.asarray(j_lm.loss_history),
                               rtol=5e-2)


def test_train_plpinn_linear_1d_sanity_reduced():
    """BASELINE config #1 reduced (400 points, [1,32,32,32,1], short
    schedule): μ at γ=0 must recover the exact 0.5 of −½Δ + ½x² to 2e-3 on
    both sides (the pretrained base is the exact eigenfunction, so the
    perturbation only has to stay small)."""
    cfg = EXPERIMENTS["linear_1d_sanity"]
    kw = dict(n_points=400, layers=(1, 32, 32, 32, 1))
    run = dict(gamma_values=cfg.gamma_values, epochs=200, pretrain_epochs=300,
               check_every=100, tol=cfg.tol, patience=cfg.patience)
    from dataclasses import replace
    tres = tpl.train_plpinn(replace(cfg.spec, **kw), device="cpu", **run)
    jspec = replace(jprob.GPESpec(**{f: getattr(cfg.spec, f) for f in (
        "lb", "ub", "dim", "activation", "potential", "potential_kwargs", "basis",
        "p", "kinetic", "nonlinearity", "bc_weight", "norm_weight")}), **kw)
    jres = jpl.train_plpinn(jspec, **run)
    mu_t, mu_j = tres.mu_table[0][0][1], jres.mu_table[0][0][1]
    assert abs(mu_t - 0.5) < 2e-3 and abs(mu_j - 0.5) < 2e-3, (mu_t, mu_j)
    assert abs(mu_t - mu_j) < 2e-3


def test_train_plpinn_2d_ramp_with_rebase():
    res = tpl.train_plpinn(tprob.GPESpec(**SPEC_2D), gamma_values=(0.0, 2.0, 5.0),
                           epochs=120, pretrain_epochs=200, check_every=60,
                           rebase=True, lm_polish=True, lm_steps=2,
                           lm_cg_iters=10, device="cpu")
    mus = [m for _, m in res.mu_table[0]]
    assert abs(mus[0] - 1.0) < 1e-2, mus
    assert mus[0] < mus[1] < mus[2], mus
    assert np.isfinite(res.polished[0]["mu"])
    assert abs(res.polished[0]["mu"] - mus[2]) < 5e-2


def test_configs_match_the_jax_registry():
    from gpe_tpu.experiments.configs import EXPERIMENTS as JEXP
    for name, cfg in EXPERIMENTS.items():
        jcfg = JEXP[name]
        for f in ("gamma_values", "modes", "epochs", "tol", "patience",
                  "perturb_const", "lr", "pretrain_epochs", "seed", "rebase",
                  "lm_polish"):
            assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
        for f in ("lb", "ub", "n_points", "dim", "layers", "activation",
                  "potential", "potential_kwargs", "basis", "p", "kinetic",
                  "nonlinearity", "bc_weight", "norm_weight", "use_perturbation"):
            assert getattr(cfg.spec, f) == getattr(jcfg.spec, f), (name, f)
