"""Port parity: physics (bases, potentials), grids and make_batch against
the JAX package on the same numpy inputs (f64 at rtol 1e-12; make_batch in
f32 at 1e-6)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.ops import quadrature as jquad  # noqa: E402
from gpe_tpu.physics import bases as jbases  # noqa: E402
from gpe_tpu.physics import potentials as jpot  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.ops import quadrature as tquad  # noqa: E402
from gpe_tpu_torch.physics import bases as tbases  # noqa: E402
from gpe_tpu_torch.physics import potentials as tpot  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

RTOL = 1e-12


def _close(got, want, rtol=RTOL, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _triples(t, j, rtol=RTOL):
    for a, b in zip(t, j):
        _close(a.numpy(), b, rtol=rtol)


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_hermite_basis(n):
    x = np.random.default_rng(n).uniform(-5.0, 5.0, 64)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jbases.hermite_basis(n, jnp.asarray(x))]
    _triples(tbases.hermite_basis(n, torch.as_tensor(x)), want)


@pytest.mark.parametrize("nx,ny", [(0, 0), (2, 1)])
def test_hermite_product_2d(nx, ny):
    xy = np.random.default_rng(7).uniform(-4.0, 4.0, (48, 2))
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jbases.hermite_product_2d(nx, ny, jnp.asarray(xy))]
    _triples(tbases.hermite_product_2d(nx, ny, torch.as_tensor(xy)), want)


def test_hermite_product_nd():
    x = np.random.default_rng(3).uniform(-3.0, 3.0, (40, 3))
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jbases.hermite_product_nd((1, 0, 2), jnp.asarray(x))]
    _triples(tbases.hermite_product_nd((1, 0, 2), torch.as_tensor(x)), want)


POTENTIAL_CASES = [
    ("harmonic", {}), ("harmonic", {"a": 0.5}),
    ("gaussian", {"V0": 2.0, "center": 0.5, "sigma": 1.3}),
    ("periodic", {}), ("box", {}), ("linear", {"g": 0.7}),
    ("gravity_well", {}), ("double_well", {"a": 0.3, "b": 2.0}),
    ("step", {"V0": 3.0, "x0": 0.2}), ("sine", {"V0": 1.5, "k": 0.8}),
    ("optical_lattice", {"V0": 4.0, "k": 0.7853981633974483}),
]


@pytest.mark.parametrize("name,kw", POTENTIAL_CASES)
@pytest.mark.parametrize("d", [1, 2])
def test_potentials(name, kw, d):
    x = np.random.default_rng(d).uniform(-6.0, 6.0, (50, d))
    with jax.enable_x64(True):
        want = np.asarray(jpot.get_potential(name, **kw)(jnp.asarray(x)))
    _close(tpot.get_potential(name, **kw)(torch.as_tensor(x)).numpy(), want)


def test_scaled_potential():
    x = np.linspace(-3.0, 3.0, 21)
    with jax.enable_x64(True):
        want = np.asarray(jpot.get_potential("harmonic", beta=2.5)(jnp.asarray(x)))
    _close(tpot.get_potential("harmonic", beta=2.5)(torch.as_tensor(x)).numpy(), want)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_uniform_grid(d):
    with jax.enable_x64(True):
        want = np.asarray(jquad.uniform_grid(-8.0, 8.0, 11, d=d))
        wt = np.asarray(jquad.trapezoid_weights(-8.0, 8.0, 11, d=d))
    _close(tquad.uniform_grid(-8.0, 8.0, 11, d=d).numpy(), want)
    _close(tquad.trapezoid_weights(-8.0, 8.0, 11, d=d).numpy(), wt)


SPECS = [
    dict(dim=2, lb=-8.0, ub=8.0, n_points=14, layers=(2, 16, 1),
         potential="harmonic", potential_kwargs=(("a", 0.5),), kinetic=0.5,
         nonlinearity="abs_power"),
    dict(dim=1, lb=-10.0, ub=10.0, n_points=100, layers=(1, 16, 1)),
    dict(dim=3, lb=-4.0, ub=4.0, n_points=5, layers=(3, 16, 1)),
    dict(dim=2, n_points=9, layers=(2, 16, 1), use_perturbation=False,
         potential="gaussian"),
]


@pytest.mark.parametrize("kw", SPECS)
def test_make_batch(kw):
    want = jprob.make_batch(jprob.GPESpec(**kw), 0)
    got = tprob.make_batch(tprob.GPESpec(**kw), 0, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
