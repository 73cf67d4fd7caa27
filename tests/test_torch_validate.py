"""Port parity: the ground-truth oracles (`gpe_tpu_torch.validate`) and the
closed forms (`physics.exact`, `physics.thomas_fermi`) against the JAX
package's on the same numpy inputs, in float64 on the CPU. The cases mirror
tests/test_validate.py, tests/test_oracles.py and tests/test_rotating.py at
smaller grids and step counts (parity needs no convergence).

Tolerances: μ relative ≤ 1e-9 and ψ max-abs ≤ 1e-7 for the FFT oracles
(imaginary time, rotating frame), the dense eigh solvers, the Newton
oracle (the same scipy code on the same inputs), `exact` and Thomas–Fermi;
ψ compared up to sign where an eigensolver picks it. The 2D SCF solver
starts ARPACK without a fixed vector on both sides (gpe_tpu/validate/
fdm.py:91,103), so it is held to its own tol (1e-8): μ within 10·tol,
ψ within 100·tol max-abs.
"""
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import importlib  # noqa: E402

import jax  # noqa: E402

from gpe_tpu.physics import exact as jexact  # noqa: E402
from gpe_tpu.validate import fdm as jfdm  # noqa: E402
from gpe_tpu.validate import rotating as jrot  # noqa: E402
from gpe_tpu.validate.imaginary_time import imaginary_time_gpe as j_itime  # noqa: E402
from gpe_tpu_torch.physics import exact as texact  # noqa: E402
from gpe_tpu_torch.physics import thomas_fermi as ttf  # noqa: E402
from gpe_tpu_torch.validate import fdm as tfdm  # noqa: E402
from gpe_tpu_torch.validate import rotating as trot  # noqa: E402
from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe as t_itime  # noqa: E402

# gpe_tpu.physics re-exports the function thomas_fermi under the module's name
jtf = importlib.import_module("gpe_tpu.physics.thomas_fermi")

MU_RTOL = 1e-9
PSI_ATOL = 1e-7


def _np(t):
    return t.detach().cpu().numpy()


def _assert_mu(got, want, rtol=MU_RTOL):
    assert abs(got - want) <= rtol * max(1.0, abs(want)), (got, want)


def _assert_psi(got, want, atol=PSI_ATOL, up_to_sign=False):
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    if up_to_sign:
        err = min(err, np.max(np.abs(got + want)))
    assert err <= atol, err


def _trap(dim, n, bc, lb=-8.0, ub=8.0):
    """V = ½|x|² on the periodic grid (n points of [lb, ub]) or on the n
    interior points of the Dirichlet box [lb, ub]."""
    if bc == "periodic":
        x = np.linspace(lb, ub, n)
    else:
        x = lb + np.arange(1, n + 1) * (ub - lb) / (n + 1)
    V = 0.5 * x * x if dim == 1 else 0.5 * (x[:, None] ** 2 + x[None, :] ** 2)
    return V, x[1] - x[0]


@pytest.mark.parametrize("richardson", [0, 1, 2])
@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
@pytest.mark.parametrize("dim", [1, 2])
def test_imaginary_time_matches_jax(dim, bc, richardson):
    n, steps = (128, 600) if dim == 1 else (32, 300)
    V, dx = _trap(dim, n, bc)
    kw = dict(kinetic=0.5, p=3.0, tau=5e-3, steps=steps, richardson=richardson, bc=bc)
    mu_j, psi_j = j_itime(V, dx, 10.0, **kw)
    mu_t, psi_t = t_itime(V, dx, 10.0, device="cpu", **kw)
    assert psi_t.dtype == torch.float64 and psi_t.device.type == "cpu"
    _assert_mu(mu_t, mu_j)
    _assert_psi(psi_t, psi_j)


def test_imaginary_time_converged_dirichlet_free_box():
    """test_validate.py's analytic free-box case (μ = c·(π/L)², ψ ∝ sin)
    through the port's DST-I, against the JAX oracle and the exact value."""
    n, L, c = 63, 8.0, 0.5
    dx = L / (n + 1)
    kw = dict(kinetic=c, tau=2e-3, steps=20000, bc="dirichlet")
    mu_j, psi_j = j_itime(np.zeros(n), dx, 0.0, **kw)
    mu_t, psi_t = t_itime(np.zeros(n), dx, 0.0, device="cpu", **kw)
    _assert_mu(mu_t, mu_j)
    _assert_psi(psi_t, psi_j)
    assert abs(mu_t - c * (np.pi / L) ** 2) < 1e-10


def test_imaginary_time_warm_start_and_p():
    """psi0 (a tensor) and p ≠ 3 reach the same state as the JAX oracle."""
    V, dx = _trap(1, 96, "periodic")
    seed = np.exp(-0.25 * (np.linspace(-8, 8, 96) - 0.5) ** 2)
    kw = dict(kinetic=1.0, p=4.0, tau=4e-3, steps=400)
    mu_j, psi_j = j_itime(V, dx, 3.0, psi0=seed, **kw)
    mu_t, psi_t = t_itime(V, dx, 3.0, psi0=torch.tensor(seed), device="cpu", **kw)
    _assert_mu(mu_t, mu_j)
    _assert_psi(psi_t, psi_j)


def test_linear_eigensolve_matches_jax():
    x = np.linspace(-10, 10, 300)
    mus_j, psis_j = jfdm.linear_eigensolve_1d(x * x, x[1] - x[0], k=4)
    mus_t, psis_t = tfdm.linear_eigensolve_1d(x * x, x[1] - x[0], k=4, device="cpu")
    np.testing.assert_allclose(_np(mus_t), mus_j, rtol=MU_RTOL)
    for i in range(4):
        _assert_psi(psis_t[:, i], psis_j[:, i], up_to_sign=True)


@pytest.mark.parametrize("gamma", [0.0, 5.0])
def test_scf_1d_matches_jax(gamma):
    x = np.linspace(-10, 10, 200)
    mu_j, psi_j = jfdm.solve_gpe_scf_1d(x * x, x[1] - x[0], gamma)
    mu_t, psi_t = tfdm.solve_gpe_scf_1d(x * x, x[1] - x[0], gamma, device="cpu")
    _assert_mu(mu_t, mu_j)
    _assert_psi(psi_t, psi_j)


@pytest.mark.parametrize("gamma", [0.0, 5.0])
def test_scf_2d_matches_jax(gamma):
    x = np.linspace(-8, 8, 21)
    V = 0.5 * (x[:, None] ** 2 + x[None, :] ** 2)
    tol = 1e-8
    mu_j, psi_j = jfdm.solve_gpe_scf_2d(V, x[1] - x[0], gamma, kinetic=0.5, tol=tol)
    mu_t, psi_t = tfdm.solve_gpe_scf_2d(V, x[1] - x[0], gamma, kinetic=0.5, tol=tol,
                                        device="cpu")
    assert abs(mu_t - mu_j) <= 10 * tol
    _assert_psi(psi_t, psi_j, atol=100 * tol)


@pytest.mark.parametrize("potential,mode,gamma,nonlinearity", [
    ("harmonic", 0, 0.0, "abs_power"),
    ("harmonic", 2, 0.0, "abs_power"),
    ("harmonic", 0, 20.0, "abs_power"),
    ("harmonic", 1, 12.0, "power"),
    ("linear", 1, 0.0, "abs_power"),
])
def test_newton_excited_matches_jax(potential, mode, gamma, nonlinearity):
    if potential == "linear":          # gravity well on x ≥ 0: ψ′(wall) ≠ 0
        x = np.linspace(0.0, 12.0, 400)
        V = x.copy()
    else:
        x = np.linspace(-8.0, 8.0, 400)
        V = x * x
    kw = dict(mode=mode, nonlinearity=nonlinearity)
    mu_j, psi_j = jfdm.solve_gpe_excited_1d(V, x[1] - x[0], gamma, **kw)
    mu_t, psi_t = tfdm.solve_gpe_excited_1d(V, x[1] - x[0], gamma, device="cpu", **kw)
    _assert_mu(mu_t, mu_j)
    _assert_psi(psi_t, psi_j)


def _rot_grid(n=32, L=6.0):
    x = np.linspace(-L, L, n, endpoint=False)
    X, Y = np.meshgrid(x, x, indexing="ij")
    return 0.5 * (X**2 + Y**2), x


@pytest.mark.parametrize("omega", [0.0, 0.7])
def test_rotating_imaginary_time_matches_jax(omega):
    V, x = _rot_grid()
    kw = dict(tau=4e-3, steps=300)
    mu_j, psi_j, lz_j = jrot.rotating_imaginary_time(V, x, 30.0, omega, **kw)
    mu_t, psi_t, lz_t = trot.rotating_imaginary_time(V, x, 30.0, omega,
                                                     device="cpu", **kw)
    assert psi_t.dtype == torch.complex128
    _assert_mu(mu_t, mu_j)
    _assert_psi(psi_t, psi_j)
    assert abs(lz_t - lz_j) <= 1e-9 * max(1.0, abs(lz_j))


def test_rotating_state_functions_match_jax():
    """rotating_mu, rotating_energy, angular_momentum, vortex_count and
    regrid_psi on one vortex-seeded state."""
    V, x = _rot_grid()
    _, psi_j, _ = jrot.rotating_imaginary_time(V, x, 30.0, 0.7, tau=4e-3, steps=200)
    psi_t = torch.tensor(psi_j)
    for jf, tf_ in ((jrot.rotating_mu, trot.rotating_mu),
                    (jrot.rotating_energy, trot.rotating_energy)):
        _assert_mu(tf_(psi_t, V, x, 30.0, 0.7), jf(psi_j, V, x, 30.0, 0.7))
    lz_j = jrot.angular_momentum(psi_j, x)
    assert abs(trot.angular_momentum(psi_t, x) - lz_j) <= 1e-9 * max(1.0, abs(lz_j))
    for threshold, halo in ((0.05, 4), (0.2, 2)):
        assert (trot.vortex_count(psi_t, threshold, halo)
                == jrot.vortex_count(psi_j, threshold, halo))
    x_dst = np.linspace(-6.0, 6.0, 40, endpoint=False)
    _assert_psi(trot.regrid_psi(psi_t, x, x_dst), jrot.regrid_psi(psi_j, x, x_dst))


@pytest.mark.parametrize("n", [0, 1, 3])
def test_exact_eigenvalues_match_jax(n):
    for a, c in ((1.0, 1.0), (0.5, 0.5)):
        _assert_mu(texact.harmonic_eigenvalue(n, a, c), jexact.harmonic_eigenvalue(n, a, c))
        _assert_mu(texact.harmonic_eigenvalue_2d(n, 1, a, c),
                   jexact.harmonic_eigenvalue_2d(n, 1, a, c))
    _assert_mu(texact.box_eigenvalue(n, 2.0, 0.5), jexact.box_eigenvalue(n, 2.0, 0.5))
    _assert_mu(texact.box_eigenvalue_2d(n, 2, 1.5), jexact.box_eigenvalue_2d(n, 2, 1.5))
    _assert_mu(texact.gravity_well_eigenvalue(n, 2.0, 0.5),
               jexact.gravity_well_eigenvalue(n, 2.0, 0.5))


@pytest.mark.parametrize("gamma", [10.0, 100.0])
def test_thomas_fermi_matches_jax(gamma):
    x = np.linspace(-10, 10, 201)
    V = 0.5 * x * x
    with jax.enable_x64(True):
        for clamp in (True, False):
            want = np.asarray(jtf.thomas_fermi(3.0, V, gamma, clamp=clamp))
            got = ttf.thomas_fermi(3.0, torch.tensor(V), gamma, clamp=clamp)
            np.testing.assert_allclose(_np(got), want, atol=PSI_ATOL, equal_nan=True)
        for tf_, jf in ((ttf.thomas_fermi_mu_1d_harmonic, jtf.thomas_fermi_mu_1d_harmonic),
                        (ttf.thomas_fermi_mu_2d_harmonic, jtf.thomas_fermi_mu_2d_harmonic),
                        (ttf.thomas_fermi_mu_3d_harmonic, jtf.thomas_fermi_mu_3d_harmonic)):
            _assert_mu(tf_(gamma, 0.5), float(jf(gamma, 0.5)))
    # a tensor γ gives a tensor
    assert math.isclose(float(ttf.thomas_fermi_mu_2d_harmonic(torch.tensor(gamma, dtype=torch.float64))),
                        ttf.thomas_fermi_mu_2d_harmonic(gamma), rel_tol=1e-15)
