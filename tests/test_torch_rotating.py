"""The rotating-frame complex-ψ problem (`gpe_tpu_torch/rotating/`) against
the JAX package's `gpe_tpu/rotating/problem.py` on the CPU, from params
carried over by `params_from_numpy`:

- `make_rotating_batch` equal to JAX's to f32 rounding (the port builds it in
  float64 first, as `make_batch` does; 1 ulp);
- `make_rotating_loss_fn` on a [2,16,16,2] net: every aux entry at rtol 2e-5
  in f32 and 1e-6 in f64 (JAX reduces in f32 even under x64, its `_red`);
- the Ω = 0 consistency of tests/test_rotating.py:55 (Im ψ = 0 against the
  real GPE loss: μ 1e-5, pde 1e-4, L_z 1e-5);
- the LM residual vector (JAX's closure, captured from its
  `train_rotating_vortex`) at 1e-5 relative to its max in f32, 1e-12 in f64,
  and three f64 LM steps from the same params (loss history rtol 1e-5, the
  LM tolerance of tests/test_torch_helmholtz.py; in f32 the CG solves part
  by ~6e-3 in three steps);
- a short `train_rotating_vortex` from the same initial params and target,
  value-only and Sobolev on a regridded grid: μ, L_z, E rtol 1e-4, pde and
  the fit MSE rtol 1e-2 (Adam and L-BFGS in f32 amplify round-off).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gpe_tpu.train.gauss_newton as jgn  # noqa: E402
from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.rotating import problem as jrot  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.rotating import problem as trot  # noqa: E402
from gpe_tpu_torch.train import gauss_newton as tgn  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

CPU = "cpu"
SPEC = dict(n_points=24, layers=(2, 16, 16, 2), gamma=5.0, omega=0.6, lb=-6.0, ub=6.0)


def _np_params(layers, seed=0, scheme="xavier_uniform", w0=4.0):
    p = jmlp.init_mlp(jax.random.PRNGKey(seed), layers, scheme=scheme, w0=w0)
    return [(np.asarray(w), np.asarray(b)) for w, b in p]


def _pair(np_params, dtype):
    jp = tuple((jnp.asarray(w, dtype), jnp.asarray(b, dtype)) for w, b in np_params)
    return jp, params_from_numpy(np_params, device=CPU, dtype=torch.float64
                                 if dtype == jnp.float64 else torch.float32)


def _batches(spec, dtype=jnp.float32):
    jb = {k: jnp.asarray(v, dtype) for k, v in jrot.make_rotating_batch(spec).items()}
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in jb.items()}
    return jb, tb


def test_batch_matches_jax():
    spec = jrot.RotatingSpec(**SPEC)
    jb = jrot.make_rotating_batch(spec)
    tb = trot.make_rotating_batch(trot.RotatingSpec(**SPEC), device=CPU)
    assert set(tb) == set(jb)
    for k in jb:
        assert tb[k].dtype == torch.float32 and tuple(tb[k].shape) == jb[k].shape
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("x64", [False, True])
def test_loss_fn_matches_jax(x64):
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        jspec, tspec = jrot.RotatingSpec(**SPEC), trot.RotatingSpec(**SPEC)
        jp, tp = _pair(_np_params(SPEC["layers"], 1), dt)
        jb, tb = _batches(jspec, dt)
        jt, ja = jrot.make_rotating_loss_fn(jspec)(jp, jb, 5.0, 0.6)
        tt, ta = trot.make_rotating_loss_fn(tspec)(tp, tb, 5.0, 0.6)
        assert tt.dtype == (torch.float64 if x64 else torch.float32)
        for k in ("total", "pde", "boundary", "norm", "mu", "lz"):
            np.testing.assert_allclose(float(ta[k]), float(ja[k]),
                                       rtol=1e-6 if x64 else 2e-5, atol=1e-12, err_msg=k)


def test_omega0_loss_is_the_real_gpe_loss():
    spec = trot.RotatingSpec(n_points=32, layers=(2, 16, 16, 2), gamma=5.0, omega=0.0,
                             lb=-6.0, ub=6.0)
    params = params_from_numpy(_np_params(spec.layers), device=CPU)
    w, b = params[-1]
    w, b = w.clone(), b.clone()
    w[:, 1], b[1] = 0.0, 0.0
    params = params[:-1] + ((w, b),)
    _, aux = trot.make_rotating_loss_fn(spec)(params, trot.make_rotating_batch(spec, CPU),
                                              5.0, 0.0)
    gspec = tprob.GPESpec(dim=2, n_points=32, layers=(2, 16, 16, 1), lb=-6.0, ub=6.0,
                          potential="harmonic", potential_kwargs=(("a", 0.5),),
                          kinetic=0.5, nonlinearity="abs_power", use_perturbation=False,
                          activation="tanh")
    real = params[:-1] + ((w[:, :1], b[:1]),)
    _, gaux = tprob.make_loss_fn(gspec)(real, tprob.make_batch(gspec, 0, device=CPU),
                                        5.0, 1.0)
    np.testing.assert_allclose(float(aux["mu"]), float(gaux["mu"]), rtol=1e-5)
    np.testing.assert_allclose(float(aux["pde"]), float(gaux["pde"]), rtol=1e-4)
    assert abs(float(aux["lz"])) < 1e-5


def _jax_residual_fn(monkeypatch, spec, target):
    """JAX's LM residual closure, captured from its train_rotating_vortex
    (one distillation step, no LM step taken)."""
    seen = {}
    real = jgn.make_lm_solver

    def spy(residual_fn, params, **kw):
        seen["fn"] = residual_fn
        return real(residual_fn, params, **kw)

    monkeypatch.setattr(jgn, "make_lm_solver", spy)
    jrot.train_rotating_vortex(spec, fit_epochs=1, lbfgs_steps=0, polish_steps=1,
                               polish_cg_iters=1, target=target)
    return seen["fn"]


def _target(spec, steps=300):
    """A vortex-seeded oracle state of the port's float64 ADI solver."""
    from gpe_tpu_torch.validate.rotating import rotating_imaginary_time
    x1 = np.linspace(spec.lb, spec.ub, spec.n_points)
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    mu, psi, lz = rotating_imaginary_time(spec.trap * (X ** 2 + Y ** 2), x1, spec.gamma,
                                          spec.omega, kinetic=spec.kinetic, tau=2e-3,
                                          steps=steps, device=CPU)
    return psi.numpy(), mu, lz


@pytest.mark.parametrize("x64", [False, True])
def test_lm_residuals_and_steps_match_jax(monkeypatch, x64):
    jspec, tspec = jrot.RotatingSpec(**SPEC), trot.RotatingSpec(**SPEC)
    jres = _jax_residual_fn(monkeypatch, jspec, _target(tspec))
    tres = trot.make_rotating_residual_fn(tspec)
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        jp, tp = _pair(_np_params(SPEC["layers"], 2), dt)
        jb, tb = _batches(jspec, dt)
        jr = np.asarray(jres(jp, jb, dt(5.0), dt(0.6)))
        tr = tres(tp, tb, 5.0, 0.6).numpy()
        np.testing.assert_allclose(tr, jr, rtol=0,
                                   atol=(1e-12 if x64 else 1e-5) * np.abs(jr).max())
        if not x64:
            return
        jl = jgn.make_lm_solver(jres, jp, steps=3, cg_iters=10)(jp, jb, dt(5.0), dt(0.6))
        jl = np.asarray(jl.loss_history)
    tl = tgn.make_lm_solver(tres, tp, steps=3, cg_iters=10)(tp, tb, 5.0, 0.6)
    np.testing.assert_allclose(tl.loss_history, jl, rtol=1e-5)


@pytest.mark.parametrize("sobolev_n", [None, 20])
def test_train_rotating_vortex_matches_jax_from_carried_params(monkeypatch, sobolev_n):
    spec_kw = dict(SPEC, n_points=24, layers=(2, 24, 24, 2), activation="sin",
                   init_scheme="siren", w0=3.0)
    jspec, tspec = jrot.RotatingSpec(**spec_kw), trot.RotatingSpec(**spec_kw)
    target = _target(tspec)
    init = _np_params(spec_kw["layers"], 0, "siren", 3.0)
    monkeypatch.setattr(trot, "init_mlp",
                        lambda *a, **kw: params_from_numpy(init, device=CPU))
    kw = dict(fit_epochs=30, lbfgs_steps=4, polish_steps=3, polish_cg_iters=10,
              target=target, sobolev=sobolev_n is not None, sobolev_n=sobolev_n or 0)
    jres = jrot.train_rotating_vortex(jspec, **kw)
    tres = trot.train_rotating_vortex(tspec, device=CPU, **kw)
    assert tres.n_vortices == jres.n_vortices
    assert (tres.mu_grid, tres.lz_grid) == (target[1], target[2])
    for k in ("mu", "lz", "energy"):
        np.testing.assert_allclose(getattr(tres, k), getattr(jres, k), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k in ("pde_loss", "fit_mse"):
        np.testing.assert_allclose(getattr(tres, k), getattr(jres, k), rtol=1e-2,
                                   err_msg=k)
