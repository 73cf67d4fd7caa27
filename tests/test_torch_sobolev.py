"""Port parity of the Sobolev-preconditioned NGD flow
(`gpe_tpu_torch/train/sobolev_ngd.py`) and of the Sobolev (H¹) pretraining
(`train/pretrain.py:pretrain_sobolev`) against the JAX package on the CPU
(small sizes).

Tolerances: in float64 (JAX under x64) the SNGD μ and residual histories
and the params at rtol 1e-10 (measured 7e-14), pretrain_sobolev's loss and
params at 1e-10 (measured 1e-14; 10 L-BFGS steps, before the line search's
amplification of round-off grows, tests/test_torch_pretrain.py). In
float32 the SNGD histories at rtol 1e-4 (Adam trajectories of other
summation orders, measured 2e-5 in μ) and the Adam-only Sobolev loss at
rtol 1e-5.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.train import pretrain as jpre  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu.train import sobolev_ngd as jsn  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402
from gpe_tpu_torch.train import sobolev_ngd as tsn  # noqa: E402
from gpe_tpu_torch.train.pretrain import pretrain_sobolev  # noqa: E402


def _kw(dim):
    kw = dict(dim=dim, n_points=32 if dim == 1 else 12, layers=(dim, 16, 16, 1),
              lb=-8.0, ub=8.0, potential="harmonic", basis="hermite",
              kinetic=1.0 if dim == 1 else 0.5, use_perturbation=False,
              nonlinearity="abs_power", activation="tanh")
    if dim == 2:
        kw["potential_kwargs"] = (("a", 0.5),)
    return kw


def _init(layers, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1 / np.sqrt(i), (i, o)), rng.normal(0, 0.1, o))
            for i, o in zip(layers[:-1], layers[1:])]


def _run(dim, f64, fn_jax, fn_torch):
    """fn_jax(spec, batch, params) and fn_torch(spec, batch, params) from the
    same params, in f64 (JAX under x64) or f32."""
    kw = _kw(dim)
    init = _init(kw["layers"])
    with jax.enable_x64(f64):
        jspec = jprob.GPESpec(**kw, dtype=jnp.float64 if f64 else jnp.float32)
        jb = jprob.make_batch(jspec, 0)
        want = fn_jax(jspec, jb, [(jnp.asarray(w, jb["x"].dtype), jnp.asarray(b, jb["x"].dtype))
                                  for w, b in init])
    tspec = tprob.GPESpec(**kw, dtype=torch.float64 if f64 else torch.float32)
    got = fn_torch(tspec, tprob.make_batch(tspec, 0, device="cpu"),
                   params_from_numpy(init, device="cpu", dtype=tspec.dtype))
    return want, got


def _sngd(dim, f64):
    def j(spec, b, p):
        r = jsn.make_sngd_solver(spec, outer_steps=5, inner_steps=7)(p, b, 3.0)
        return (np.asarray(r.mu_history), np.asarray(r.loss_history),
                [np.asarray(a) for pair in r.params for a in pair], r.mu, r.pde_loss)

    def t(spec, b, p):
        r = tsn.make_sngd_solver(spec, outer_steps=5, inner_steps=7)(p, b, 3.0)
        return (r.mu_history, r.loss_history, [a.numpy() for pair in r.params for a in pair],
                r.mu, r.pde_loss)

    return _run(dim, f64, j, t)


@pytest.mark.parametrize("dim", [1, 2])
def test_sngd_matches_jax_f64(dim):
    want, got = _sngd(dim, True)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-10)
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    assert got[3] == got[0][-1] and got[4] == got[1][-1]


def test_sngd_matches_jax_f32():
    want, got = _sngd(2, False)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)


def test_sngd_refuses_3d():
    spec = tprob.GPESpec(dim=3, n_points=6, layers=(3, 8, 1))
    with pytest.raises(ValueError, match="dims 1 and 2"):
        tsn.make_sngd_solver(spec)


def _sobolev(dim, f64, lbfgs_steps):
    def targets(spec_mod, spec, x):
        bt = spec_mod.base_triple(spec, 0, x)
        return bt.value, bt.grad[..., None]

    def j(spec, b, p):
        tv, tj = targets(jprob, spec, b["x"])
        p, loss = jpre.pretrain_sobolev(p, b["x"], np.asarray(tv), np.asarray(tj), "tanh",
                                        epochs=30, lbfgs_steps=lbfgs_steps)
        return [np.asarray(a) for pair in p for a in pair], loss

    def t(spec, b, p):
        tv, tj = targets(tprob, spec, b["x"])
        p, loss = pretrain_sobolev(p, b["x"], tv, tj, "tanh", epochs=30,
                                   lbfgs_steps=lbfgs_steps)
        return [a.numpy() for pair in p for a in pair], loss

    return _run(dim, f64, j, t)


@pytest.mark.parametrize("dim", [1, 2])
def test_pretrain_sobolev_matches_jax_f64(dim):
    want, got = _sobolev(dim, True, 10)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-10)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


def test_pretrain_sobolev_adam_matches_jax_f32():
    want, got = _sobolev(2, False, 0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
