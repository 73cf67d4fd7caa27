"""Port parity of `pretrain_to_base` (Adam, then optax's L-BFGS with its
zoom line search) against the JAX package on the CPU.

Tolerances. float64 (JAX under enable_x64): after 200 Adam steps the
params meet JAX's to 7e-16; each L-BFGS step's line search then amplifies
the two packages' other summation orders, faster as the steps go (on
[1,16,16,1] at 128 points, params / relative MSE, the worst of seeds 0–3:
1e-12 / 5e-12 after 20 steps, 3e-11 / 1.2e-10 after 30, 2e-9 / 2.1e-8
after 40, 1.4e-6 / 2.3e-6 after 50). So seeds 0–2 are held at
LBFGS_F64_TOL (1e-9) after 30 steps, and after 50 steps at
LBFGS_F64_TOL_50 (1e-5, four times the worst reading). float32 Adam (10
steps) at rtol 1e-6 in the MSE.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.train import pretrain as jpre  # noqa: E402
from gpe_tpu_torch.models.mlp import mlp_apply, params_from_numpy  # noqa: E402
from gpe_tpu_torch.train.pretrain import pretrain_to_base, run_lbfgs  # noqa: E402

LBFGS_F64_TOL, LBFGS_F64_TOL_50 = 1e-9, 1e-5


def _case(layers=(1, 16, 16, 1), n=128, seed=1):
    rng = np.random.default_rng(seed)
    init = [(rng.normal(0, 1 / np.sqrt(i), (i, o)), rng.normal(0, 0.1, o))
            for i, o in zip(layers[:-1], layers[1:])]
    x = np.linspace(-5.0, 5.0, n)[:, None]
    return init, x, np.exp(-x[:, 0] ** 2 / 2) * np.pi ** -0.25


def _jax(init, x, target, dtype, **kw):
    with jax.enable_x64(dtype == np.float64):
        p, mse = jpre.pretrain_to_base([(jnp.asarray(w, dtype), jnp.asarray(b, dtype))
                                        for w, b in init],
                                       jnp.asarray(x, dtype), jnp.asarray(target, dtype),
                                       "tanh", **kw)
        return [(np.asarray(w), np.asarray(b)) for w, b in p], float(mse)


def _torch(init, x, target, dtype, **kw):
    return pretrain_to_base(params_from_numpy(init, device="cpu", dtype=dtype),
                            torch.as_tensor(x, dtype=dtype),
                            torch.as_tensor(target, dtype=dtype), "tanh", **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("steps,tol", [(30, LBFGS_F64_TOL), (50, LBFGS_F64_TOL_50)])
def test_pretrain_to_base_matches_jax_f64(seed, steps, tol):
    """200 Adam steps, then `steps` L-BFGS steps, float64: params and the
    MSE."""
    init, x, target = _case(seed=seed)
    jp, jmse = _jax(init, x, target, np.float64, epochs=200, lbfgs_steps=steps)
    tp, tmse = _torch(init, x, target, torch.float64, epochs=200, lbfgs_steps=steps)
    np.testing.assert_allclose(tmse, jmse, rtol=tol)
    for (tw, tb), (jw, jb) in zip(tp, jp):
        np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=tol)
        np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=tol)


def test_pretrain_to_base_runs_every_lbfgs_step():
    """lbfgs_steps=400 runs 400 L-BFGS steps (torch.optim.LBFGS stopped
    after 71 closure calls on its tolerances), each lowering or keeping the
    MSE the Adam phase left."""
    init, x, target = _case(layers=(1, 8, 8, 1), n=64, seed=0)
    before = run_lbfgs.steps
    _, adam_mse = _torch(init, x, target, torch.float32, epochs=100, lbfgs_steps=0)
    p, mse = _torch(init, x, target, torch.float32, epochs=100, lbfgs_steps=400)
    assert run_lbfgs.steps - before == 400
    assert np.isfinite(mse) and mse < adam_mse
    assert all(np.isfinite(w.numpy()).all() for pair in p for w in pair)


def test_pretrain_to_base_returns_the_mse_before_the_last_step():
    """JAX returns losses[-1] of its scan, the loss before the last update:
    10 Adam steps give JAX's number and the MSE of the port's params after 9
    steps; a tol above that MSE skips the L-BFGS phase."""
    init, x, target = _case()
    _, jmse = _jax(init, x, target, np.float32, epochs=10, lbfgs_steps=0)
    _, tmse = _torch(init, x, target, torch.float32, epochs=10, lbfgs_steps=0)
    p9, _ = _torch(init, x, target, torch.float32, epochs=9, lbfgs_steps=0)
    np.testing.assert_allclose(tmse, jmse, rtol=1e-6)
    mse9 = float(torch.mean((mlp_apply(p9, torch.as_tensor(x, dtype=torch.float32), "tanh")
                             - torch.as_tensor(target, dtype=torch.float32)) ** 2))
    np.testing.assert_allclose(tmse, mse9, rtol=1e-6)
    before = run_lbfgs.steps
    _, gated = _torch(init, x, target, torch.float32, epochs=10, lbfgs_steps=5,
                      tol=2 * tmse)
    assert run_lbfgs.steps == before and gated == tmse
    _torch(init, x, target, torch.float32, epochs=10, lbfgs_steps=5, tol=tmse / 2)
    assert run_lbfgs.steps == before + 5


@pytest.mark.parametrize("epochs", [1, 3])
def test_pretrain_to_base_short_adam_phases_match_jax_f64(epochs):
    """The graph-free short phases (≤ 2 steps, and 3) read JAX's MSE."""
    init, x, target = _case()
    _, jmse = _jax(init, x, target, np.float64, epochs=epochs, lbfgs_steps=3)
    _, tmse = _torch(init, x, target, torch.float64, epochs=epochs, lbfgs_steps=3)
    np.testing.assert_allclose(tmse, jmse, rtol=1e-12)
