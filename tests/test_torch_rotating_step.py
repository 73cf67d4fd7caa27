"""The rotating-frame Bao–Wang ADI stepper (`gpe_tpu_torch/dynamics/
rotating_step.py`) against the JAX package's `gpe_tpu/dynamics/
rotating_step.py` in float64 (under jax.enable_x64) from the same ψ₀, and the
oracles of tests/test_rotating_dynamics.py at their bounds, on the CPU:

- the same function: ψ and every observable against JAX to 1e-12 (f64 FFTs
  in another order; measured ≤ 1e-13), real and imaginary time, and
  `rotating_ground_state` with the shared numpy vortex seed;
- rotating-frame Kohn splitting (centre 2e-5, norm 1e-11, energy 2e-5);
- against the port's float64 oracle `validate/rotating.py` from an identical
  state: μ and L_z 1e-9, overlap 1e-11;
- the remainder record (0, 50, 100, 130 and the true final state).
"""
import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from gpe_tpu.dynamics import evolve_rotating as j_evolve  # noqa: E402
from gpe_tpu.dynamics import rotating_ground_state as j_ground  # noqa: E402
from gpe_tpu_torch.dynamics import evolve_rotating, rotating_ground_state  # noqa: E402

CPU = "cpu"
KEYS = ("norm", "energy", "mu", "lz", "center", "width_sq")


def _grid(n, half):
    x = np.linspace(-half, half, n, endpoint=False)
    dx = x[1] - x[0]
    X, Y = np.meshgrid(x, x, indexing="ij")
    return x, dx, X, Y


def _seeded(X, Y, seed=3):
    rng = np.random.default_rng(seed)
    psi0 = np.exp(-(X ** 2 + Y ** 2) / 2.0) * ((X - 0.3) + 1j * (Y + 0.2))
    return psi0 + 0.01 * (rng.standard_normal(psi0.shape)
                          + 1j * rng.standard_normal(psi0.shape))


@pytest.mark.parametrize("imaginary", [False, True])
def test_evolve_rotating_matches_jax_in_f64(imaginary):
    n, half, gam, om = 48, 7.0, 20.0, 0.6
    x, dx, X, Y = _grid(n, half)
    V = 0.5 * (X ** 2 + Y ** 2)
    psi0 = _seeded(X, Y)
    psi0 /= np.sqrt(np.sum(np.abs(psi0) ** 2) * dx * dx)
    args = (V, dx, 1e-3, 70, gam, om, 0.5, 3.0)
    with jax.enable_x64(True):
        jpsi, jobs = j_evolve(psi0, *args, lb=float(x[0]), imaginary=imaginary,
                              record_every=30)
        jpsi = np.asarray(jpsi)
    psi, obs = evolve_rotating(psi0, *args, lb=float(x[0]), imaginary=imaginary,
                               record_every=30, device=CPU)
    assert psi.dtype == torch.complex128
    np.testing.assert_allclose(psi.numpy(), jpsi, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(obs["t"], jobs["t"])
    for k in KEYS:
        np.testing.assert_allclose(obs[k], np.asarray(jobs[k]), rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_f32_potential_takes_complex64():
    x, dx, X, Y = _grid(16, 5.0)
    V = (0.5 * (X ** 2 + Y ** 2)).astype(np.float32)
    psi, obs = evolve_rotating(np.exp(-(X ** 2 + Y ** 2)), V, dx, 1e-3, 3, 1.0, 0.3,
                               device=CPU)
    assert psi.dtype == torch.complex64 and obs["mu"].dtype == np.float32
    with pytest.raises(ValueError, match="2D"):
        evolve_rotating(np.ones(8), np.ones(8), 0.1, 1e-3, 1, 1.0, 0.3, device=CPU)


def test_rotating_ground_state_matches_jax_with_the_vortex_seed():
    n, half, gam, om = 48, 7.0, 20.0, 0.7
    x, dx, X, Y = _grid(n, half)
    V = 0.5 * (X ** 2 + Y ** 2)
    kw = dict(tau=2e-3, steps=600, tol=0.0, lb=float(x[0]), chunk=200)
    with jax.enable_x64(True):
        jmu, jpsi, jlz = j_ground(V, dx, gam, om, **kw)
        jpsi = np.asarray(jpsi)
    mu, psi, lz = rotating_ground_state(V, dx, gam, om, device=CPU, **kw)
    assert abs(mu - jmu) < 1e-12 and abs(lz - jlz) < 1e-12
    np.testing.assert_allclose(psi.numpy(), jpsi, rtol=0, atol=1e-12)


def test_kohn_splitting_norm_and_energy():
    n, half, d, gam, om = 96, 8.0, 0.5, 20.0, 0.5
    x, dx, X, Y = _grid(n, half)
    V = 0.5 * (X ** 2 + Y ** 2)
    psi0 = np.exp(-0.5 * ((X - d) ** 2 + Y ** 2))
    psi0 = psi0 / np.sqrt(np.sum(psi0 ** 2) * dx * dx)
    _, obs = evolve_rotating(psi0, V, dx, 2e-3, 3000, gamma=gam, omega=om,
                             kinetic=0.5, lb=float(x[0]), record_every=100, device=CPU)
    t, cx, cy = obs["t"], obs["center"][:, 0], obs["center"][:, 1]
    assert np.max(np.abs(cx - d * np.cos(t) * np.cos(om * t))) < 2e-5
    assert np.max(np.abs(cy + d * np.cos(t) * np.sin(om * t))) < 2e-5
    assert np.max(np.abs(obs["norm"] - 1.0)) < 1e-11
    assert np.max(np.abs(obs["energy"] / obs["energy"][0] - 1.0)) < 2e-5


def test_matches_the_ports_rotating_oracle():
    from gpe_tpu_torch.validate.rotating import (angular_momentum,
                                                 rotating_imaginary_time, rotating_mu)

    n, half, gam, om = 96, 8.0, 30.0, 0.7
    x, dx, X, Y = _grid(n, half)
    V = 0.5 * (X ** 2 + Y ** 2)
    psi0 = _seeded(X, Y)
    steps = 1200
    mu_np, psi_np, lz_np = rotating_imaginary_time(V, x, gam, om, tau=2e-3, steps=steps,
                                                   tol=0.0, psi0=psi0, device=CPU)
    mu, psi, lz = rotating_ground_state(V, dx, gam, om, tau=2e-3, steps=steps, tol=0.0,
                                        lb=float(x[0]), psi0=psi0, chunk=200, device=CPU)
    assert abs(mu - mu_np) < 1e-9 and abs(lz - lz_np) < 1e-9
    ov = abs(torch.sum(torch.conj(psi) * psi_np) * dx * dx)
    assert abs(float(ov) - 1.0) < 1e-11
    assert abs(rotating_mu(psi, V, x, gam, om) - mu) < 1e-9
    assert abs(angular_momentum(psi, x) - lz) < 1e-9


def test_remainder_steps_record_final_observables():
    n, half = 64, 6.0
    x, dx, X, Y = _grid(n, half)
    V = 0.5 * (X ** 2 + Y ** 2)
    psi0 = np.exp(-0.5 * ((X - 0.4) ** 2 + Y ** 2)).astype(complex)
    psi0 = psi0 / np.sqrt(np.sum(np.abs(psi0) ** 2) * dx * dx)
    run = lambda every: evolve_rotating(psi0, V, dx, 1e-3, 130, gamma=5.0, omega=0.3,
                                        lb=float(x[0]), record_every=every, device=CPU)
    psi_a, obs_a = run(50)
    assert len(obs_a["t"]) == 4 and abs(obs_a["t"][-1] - 0.130) < 1e-12
    psi_b, obs_b = run(130)
    np.testing.assert_allclose(psi_a.numpy(), psi_b.numpy(), atol=1e-14)
    assert abs(float(obs_a["mu"][-1]) - float(obs_b["mu"][-1])) < 1e-12
