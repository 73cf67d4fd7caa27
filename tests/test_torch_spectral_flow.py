"""Port parity of the spectral-flow solver (`gpe_tpu_torch/train/spectral_flow.py`)
against the JAX package on the CPU (small sizes); tests/test_torch_flagship.py
holds its float32 runs, its `report` and the 2D flagship driver.

Tolerances. dst1 against scipy at 1e-5 (f32) and 1e-12 (f64). The whole
solver in float64 (JAX under x64; no LM polish): the grid μ and fit
histories, μ_grid, the converged target and μ/pde of the report within
1e-9 relative (measured ≤ 2e-14 in the histories and targets; the
distillation's L-BFGS amplifies summation-order round-off in the params,
1e-9 in μ after its 5 steps). With the LM polish (2 steps, 10 CG
iterations) μ at 1e-6 (CG amplifies matvec round-off by the normal matrix's
condition number, as the f64 LM endgame of tests/test_torch_run.py).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu.train import spectral_flow as jsf  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402
from gpe_tpu_torch.train import spectral_flow as tsf  # noqa: E402

F64_RTOL = 1e-9
# the cut of the solver's schedule for the CPU
CUT = dict(outer_steps=3, inner_steps=5, final_inner_steps=20, final_lbfgs_steps=5,
           endgame_steps=3000)
CASES = {
    "1d_periodic": dict(dim=1, n_points=32, lb=-8.0, ub=8.0, potential="harmonic",
                        basis="hermite", kinetic=1.0),
    "1d_dirichlet_box": dict(dim=1, n_points=34, lb=0.0, ub=1.0, potential="box",
                             basis="box", kinetic=1.0),
    "2d_periodic": dict(dim=2, n_points=12, lb=-8.0, ub=8.0, potential="harmonic",
                        potential_kwargs=(("a", 0.5),), basis="hermite", kinetic=0.5),
    "2d_dirichlet": dict(dim=2, n_points=12, lb=-8.0, ub=8.0, potential="harmonic",
                         potential_kwargs=(("a", 0.5),), basis="hermite", kinetic=0.5),
}
BC = {"1d_periodic": "periodic", "1d_dirichlet_box": "dirichlet", "2d_periodic": "periodic",
      "2d_dirichlet": "dirichlet"}
FLAGSHIP = dict(dim=2, n_points=224, layers=(2, 128, 128, 128, 1), potential="harmonic",
                potential_kwargs=(("a", 0.5),), kinetic=0.5, lb=-8.0, ub=8.0,
                use_perturbation=False, basis="hermite", nonlinearity="abs_power")


def _kw(case, width=16):
    kw = dict(CASES[case])
    return dict(kw, layers=(kw["dim"], width, width, 1), use_perturbation=False,
                nonlinearity="abs_power", activation="tanh")


def _init(layers, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1 / np.sqrt(i), (i, o)), rng.normal(0, 0.1, o))
            for i, o in zip(layers[:-1], layers[1:])]


def _both(kw, f64, gamma=3.0, **solver_kw):
    """(JAX's FlowResult as numpy, the port's FlowResult) from the same
    params and batch."""
    init = _init(kw["layers"])
    with jax.enable_x64(f64):
        jspec = jprob.GPESpec(**kw, dtype=jnp.float64 if f64 else jnp.float32)
        jb = jprob.make_batch(jspec, 0)
        jp = [(jnp.asarray(w, jb["x"].dtype), jnp.asarray(b, jb["x"].dtype))
              for w, b in init]
        jr = jsf.make_spectral_flow_solver(jspec, **solver_kw)(jp, jb, gamma)
        jr = jr._replace(params=[(np.asarray(w), np.asarray(b)) for w, b in jr.params],
                         mu_history=np.asarray(jr.mu_history),
                         fit_history=np.asarray(jr.fit_history),
                         target=np.asarray(jr.target))
    tspec = tprob.GPESpec(**kw, dtype=torch.float64 if f64 else torch.float32)
    tb = tprob.make_batch(tspec, 0, device="cpu")
    tr = tsf.make_spectral_flow_solver(tspec, **solver_kw)(
        params_from_numpy(init, device="cpu", dtype=tspec.dtype), tb, gamma)
    return jr, tr


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dst1_matches_scipy_jax_and_is_involutory(dtype):
    from scipy.fft import dstn

    rng = np.random.default_rng(0)
    a = rng.normal(size=(7, 13)).astype(dtype)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    for axis in (0, 1, -1):
        ours = tsf.dst1(torch.as_tensor(a), axis=axis).numpy()
        ref = dstn(a.astype(np.float64), type=1, norm="ortho", axes=[axis])
        np.testing.assert_allclose(ours, ref, atol=tol)
        with jax.enable_x64(dtype == np.float64):
            np.testing.assert_allclose(ours, np.asarray(jsf.dst1(jnp.asarray(a), axis=axis)),
                                       atol=tol)
    twice = tsf.dst1(tsf.dst1(torch.as_tensor(a), 0), 0).numpy()
    np.testing.assert_allclose(twice, a, atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_matches_jax_f64(case):
    """The interleave (flow blocks, grid μ, Adam distillation), the f64
    endgame, the rescale and the final distillation, in float64."""
    jr, tr = _both(_kw(case), True, bc=BC[case], **CUT)
    assert tr.mu_history.shape == (CUT["outer_steps"] + 1,)
    np.testing.assert_allclose(tr.mu_history, jr.mu_history, rtol=F64_RTOL)
    np.testing.assert_allclose(tr.fit_history, jr.fit_history, rtol=F64_RTOL)
    np.testing.assert_allclose(tr.mu_grid, jr.mu_grid, rtol=F64_RTOL)
    np.testing.assert_allclose(tr.target, jr.target, rtol=0, atol=F64_RTOL)
    np.testing.assert_allclose(tr.mu, jr.mu, rtol=F64_RTOL)
    np.testing.assert_allclose(tr.pde_loss, jr.pde_loss, rtol=F64_RTOL)
    for (tw, tb), (jw, jb) in zip(tr.params, jr.params):
        np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=F64_RTOL)
        np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=F64_RTOL)
    assert set(tr.seconds) == {"interleave", "endgame", "distill", "polish", "report"}
    if BC[case] == "dirichlet":
        g = tr.target.reshape((CASES[case]["n_points"],) * CASES[case]["dim"])
        for ax in range(g.ndim):
            assert not np.take(g, [0, -1], axis=ax).any()


def test_solver_lm_polish_matches_jax_f64():
    jr, tr = _both(_kw("1d_periodic"), True, polish_steps=2, polish_cg_iters=10, **CUT)
    np.testing.assert_allclose(tr.mu_history, jr.mu_history, rtol=F64_RTOL)
    np.testing.assert_allclose(tr.mu, jr.mu, rtol=1e-6)
    np.testing.assert_allclose(tr.pde_loss, jr.pde_loss, rtol=1e-6)


