"""Port parity of the numeric sine-series bases (`gpe_tpu_torch/physics/
numeric.py`) and of `make_batch` with a `numeric:` basis, against the JAX
package (`gpe_tpu/physics/numeric.py`), plus the port's counterparts of
tests/test_numeric_basis.py with its bounds.

Tolerances. Spectral exactness against the analytic Gaussian as in the JAX
tests: value 1e-12, ∇ 1e-11, Δ 1e-9. Port against JAX in float64: each of
value, ∇, Δ within 1e-11 of its max |·| (measured 2.7e-15 and 5.3e-16 on
the random states, 1.5e-13 on the committed lattice state at the 16,384
collocation points: both sides take the same orthonormal DST-I, by scipy
and by an FFT of the odd extension, and the same products). `make_batch`
key by key in float32: 1e-6 of max(1, each key's max |·|) (measured ≤
5.4e-7; JAX evaluates the base at the float32 points, the port at the
float64 ones, a few ulps apart). The 1D box
PL-PINN recovers π² within 5e-2, as in JAX.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from gpe_tpu.physics import numeric as jnum  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.physics import numeric as tnum  # noqa: E402
from gpe_tpu_torch.physics.numeric import (SineSeries1D, SineSeries2D,  # noqa: E402
                                           register_numeric_basis)
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

CACHE = "runs/gpe2d_lattice/oracle_cache.npz"


def _interior_grid(lb, ub, n):
    h = (ub - lb) / (n + 1)
    return lb + h * np.arange(1, n + 1), h


def test_sine_series_1d_matches_analytic_gaussian():
    lb, ub, n = -8.0, 8.0, 255
    xi, _ = _interior_grid(lb, ub, n)
    psi = np.pi ** -0.25 * np.exp(-xi ** 2 / 2)
    s = SineSeries1D(xi, psi, lb, ub)
    pts = np.linspace(-5.0, 5.0, 333)[:, None]
    t = s(pts)
    v = np.pi ** -0.25 * np.exp(-pts[:, 0] ** 2 / 2)
    assert t.value.dtype == torch.float64 and t.grad.shape == (333, 1)
    assert np.abs(t.value.numpy() - v).max() < 1e-12
    assert np.abs(t.grad[:, 0].numpy() + pts[:, 0] * v).max() < 1e-11
    # Δφ = (x²−1)φ for the oscillator ground state
    assert np.abs(t.lap.numpy() - (pts[:, 0] ** 2 - 1) * v).max() < 1e-9


def test_sine_series_2d_matches_analytic_gaussian():
    lb, ub, n = -8.0, 8.0, 255
    xi, _ = _interior_grid(lb, ub, n)
    X, Y = np.meshgrid(xi, xi, indexing="ij")
    psi = np.pi ** -0.5 * np.exp(-(X ** 2 + Y ** 2) / 2)
    s = SineSeries2D(xi, psi, lb, ub)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5.0, 5.0, (400, 2))
    t = s(torch.as_tensor(pts))
    r2 = pts[:, 0] ** 2 + pts[:, 1] ** 2
    v = np.pi ** -0.5 * np.exp(-r2 / 2)
    assert np.abs(t.value.numpy() - v).max() < 1e-12
    assert np.abs(t.grad[:, 0].numpy() + pts[:, 0] * v).max() < 1e-11
    assert np.abs(t.lap.numpy() - (r2 - 2) * v).max() < 1e-9


@pytest.mark.parametrize("cls", [SineSeries1D, SineSeries2D])
def test_sine_series_rejects_wrong_grid(cls):
    xi = np.linspace(0.0, 1.0, 64)          # includes endpoints — not interior
    psi = np.ones(64) if cls is SineSeries1D else np.ones((64, 64))
    with pytest.raises(ValueError, match="interior DST-I grid"):
        cls(xi, psi, 0.0, 1.0)
    if cls is SineSeries2D:
        xi, _ = _interior_grid(0.0, 1.0, 64)
        with pytest.raises(ValueError, match="psi shape"):
            cls(xi, np.ones((64, 63)), 0.0, 1.0)


def test_numeric_basis_spec_wiring():
    lb, ub, n = 0.0, 1.0, 127
    xi, _ = _interior_grid(lb, ub, n)
    phi = np.sqrt(2.0) * np.sin(np.pi * xi)
    name = register_numeric_basis("wiring_test", SineSeries1D(xi, phi, lb, ub))
    assert name == "numeric:wiring_test" and name in tnum.NUMERIC_BASES
    spec = tprob.GPESpec(lb=lb, ub=ub, n_points=256, potential="box", basis=name,
                         layers=(1, 16, 16, 1))
    batch = tprob.make_batch(spec, 0, device="cpu")
    x = batch["x"].numpy()[:, 0]
    assert batch["base_val"].dtype == torch.float32
    assert np.allclose(batch["base_val"].numpy(), np.sqrt(2.0) * np.sin(np.pi * x), atol=1e-5)
    assert np.allclose(batch["base_lap"].numpy(),
                       -np.pi ** 2 * np.sqrt(2.0) * np.sin(np.pi * x), atol=1e-3)
    # boundary values of a Dirichlet sine series vanish identically
    assert np.abs(batch["base_bval"].numpy()).max() < 1e-6
    with pytest.raises(KeyError, match="no mode 3"):
        tprob.make_batch(spec, 3, device="cpu")     # only mode 0 registered
    with pytest.raises(KeyError, match="register_numeric_basis"):
        tprob.make_batch(tprob.GPESpec(basis="numeric:never_registered"), 0, device="cpu")


def test_plpinn_with_numeric_base_recovers_box_eigenvalue():
    """PL-PINN at γ=0 with a numeric base = grid-sampled box ground state:
    μ recovers π² (−Δ on [0,1]), on the port's CPU path."""
    from gpe_tpu_torch.train.plpinn import train_plpinn

    lb, ub, n = 0.0, 1.0, 255
    xi, _ = _interior_grid(lb, ub, n)
    phi = np.sqrt(2.0) * np.sin(np.pi * xi)
    name = register_numeric_basis("box_gs", SineSeries1D(xi, phi, lb, ub))
    spec = tprob.GPESpec(lb=lb, ub=ub, n_points=512, potential="box", basis=name,
                         layers=(1, 24, 24, 1), p=3.0, kinetic=1.0)
    res = train_plpinn(spec, [0.0], modes=(0,), epochs=600, tol=0.0,
                       patience=10 ** 9, pretrain_epochs=400, check_every=300,
                       device="cpu")
    mu = dict(res.mu_table[0])[0.0]
    assert abs(mu - np.pi ** 2) < 5e-2


def _assert_triples_close(got, want, rtol=1e-11):
    for a, b, what in ((got.value, want.value, "value"), (got.grad, want.grad, "grad"),
                       (got.lap, want.lap, "lap")):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=rtol * np.abs(b).max(),
                                   err_msg=what)


def test_sine_series_1d_matches_jax():
    lb, ub, n = -3.0, 5.0, 101
    xi, _ = _interior_grid(lb, ub, n)
    psi = np.random.default_rng(1).standard_normal(n)
    pts = np.random.default_rng(2).uniform(lb, ub, (257, 1))
    _assert_triples_close(SineSeries1D(xi, psi, lb, ub)(pts),
                          jnum.SineSeries1D(xi, psi, lb, ub)(pts))


@pytest.mark.parametrize("state", ["random", "lattice_gamma0"])
def test_sine_series_2d_matches_jax(state):
    """A random state on a 63² grid at random points, and the committed
    cache's γ = 0 lattice state (255²) at the lattice driver's 16,384
    collocation points."""
    if state == "random":
        lb, ub, n = -2.0, 6.0, 63
        xi, _ = _interior_grid(lb, ub, n)
        psi = np.random.default_rng(3).standard_normal((n, n))
        pts = np.random.default_rng(4).uniform(lb, ub, (500, 2))
    else:
        cache = np.load(CACHE)
        xi, dx = cache["xi"], float(cache["dx"])
        lb, ub = float(xi[0] - dx), float(xi[-1] + dx)
        psi = cache["psis"][0]
        x1 = np.linspace(lb, ub, 128)
        X, Y = np.meshgrid(x1, x1, indexing="ij")
        pts = np.stack([X.ravel(), Y.ravel()], -1)
    _assert_triples_close(SineSeries2D(xi, psi, lb, ub)(pts),
                          jnum.SineSeries2D(xi, psi, lb, ub)(pts))


def _lattice_kw(n_points):
    cache = np.load(CACHE)
    xi, dx = cache["xi"], float(cache["dx"])
    lb, ub = float(xi[0] - dx), float(xi[-1] + dx)
    jname = jnum.register_numeric_basis(
        "lattice_gs", jnum.SineSeries2D(xi, cache["psis"][0], lb, ub))
    tname = register_numeric_basis("lattice_gs", SineSeries2D(xi, cache["psis"][0], lb, ub))
    assert jname == tname
    return dict(dim=2, lb=lb, ub=ub, n_points=n_points, layers=(2, 16, 16, 1),
                potential="optical_lattice",
                potential_kwargs=(("V0", 4.0), ("k", 0.7853981633974483)),
                basis=tname, kinetic=0.5, nonlinearity="abs_power")


def _box_kw(n_points):
    lb, ub, n = 0.0, 1.0, 127
    xi, _ = _interior_grid(lb, ub, n)
    phi = np.sqrt(2.0) * np.sin(np.pi * xi) + 0.1 * np.sin(3 * np.pi * xi)
    jname = jnum.register_numeric_basis("box_1d", jnum.SineSeries1D(xi, phi, lb, ub))
    tname = register_numeric_basis("box_1d", SineSeries1D(xi, phi, lb, ub))
    assert jname == tname
    return dict(lb=lb, ub=ub, n_points=n_points, potential="box", basis=tname,
                layers=(1, 16, 16, 1), symmetry="interval", sym_weight=1.0)


@pytest.mark.parametrize("case", ["1d_box_symmetric", "2d_lattice"])
def test_make_batch_with_numeric_basis_matches_jax(case):
    """Every key of the batch (interior base triple, the boundary probes'
    base_bval, the reflected points' base in 1D), port against JAX."""
    kw = _box_kw(200) if case == "1d_box_symmetric" else _lattice_kw(24)
    want = jprob.make_batch(jprob.GPESpec(**kw), 0)
    got = tprob.make_batch(tprob.GPESpec(**kw), 0, device="cpu")
    assert set(got) == set(want)
    if case == "1d_box_symmetric":
        assert "base_val_reflect" in got
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == torch.float32, k
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-6 * scale, err_msg=k)
