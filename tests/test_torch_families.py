"""Port parity for the box, gravity-well and Gaussian families' building
blocks against the JAX package, on the same numpy-seeded inputs (CPU):
the box and Airy bases, the ansätze, the disk geometry, the Rayleigh and
quadrature reductions, every `gpe_terms` term and `make_batch` for the disk
and each symmetry.

Tolerances: analytic bases, the sine factor and the ansatz triples in f64
at rtol 1e-12. The Airy table keeps the JAX package's float32 knots, so a
float64 evaluation meets JAX's under x64 at 1e-12 (the same interpolation
of the same knots) and a float32 one its f32 evaluation at rel 1e-6 (f32
round-off of the interpolation; ≤ 1.2e-7 of the function's peak here).
The disk points and weights are bit-equal. The reductions and loss terms
at rel 1e-6 from f64 inputs: the JAX package accumulates every quadrature
sum in float32 even under x64 (`_red`, `integrate`, `wmean`), the port in
the inputs' f64, so the two differ by f32 summation round-off. make_batch
in f64 at 1e-12.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.losses import gpe as jgpe  # noqa: E402
from gpe_tpu.models import ansatz as jans  # noqa: E402
from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.ops import geometry as jgeo  # noqa: E402
from gpe_tpu.ops import quadrature as jquad  # noqa: E402
from gpe_tpu.ops import rayleigh as jray  # noqa: E402
from gpe_tpu.physics import bases as jbases  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.losses import gpe as tgpe  # noqa: E402
from gpe_tpu_torch.models import ansatz as tans  # noqa: E402
from gpe_tpu_torch.models import mlp as tmlp  # noqa: E402
from gpe_tpu_torch.ops import geometry as tgeo  # noqa: E402
from gpe_tpu_torch.ops import quadrature as tquad  # noqa: E402
from gpe_tpu_torch.ops import rayleigh as tray  # noqa: E402
from gpe_tpu_torch.physics import bases as tbases  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

F64 = 1e-12
SUMS = 1e-6


def _close(got, want, rtol=F64, atol=1e-13):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _triples(t, j, rtol=F64, atol=1e-13):
    for a, b in zip(t, j):
        _close(a, b, rtol, atol)


@pytest.mark.parametrize("n,L", [(0, 1.0), (1, 1.0), (4, 2.5)])
def test_box_basis(n, L):
    x = np.random.default_rng(n).uniform(0.0, L, 64)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jbases.box_basis(n, jnp.asarray(x), L)]
    _triples(tbases.box_basis(n, torch.as_tensor(x), L), want)


def test_box_basis_2d():
    xy = np.random.default_rng(5).uniform(0.0, 2.0, (48, 2))
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jbases.box_basis_2d(2, 1, jnp.asarray(xy), 2.0)]
    _triples(tbases.box_basis_2d(2, 1, torch.as_tensor(xy), 2.0), want)


@pytest.mark.parametrize("n", [0, 1, 5])
def test_airy_basis_f64(n):
    """z spans the table's inside, its clipped ends and x = 0 (the well's
    wall, where ψₙ vanishes)."""
    x = np.concatenate([[0.0, 35.0, 70.0], np.random.default_rng(n).uniform(0.0, 35.0, 97)])
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jbases.airy_basis(n, jnp.asarray(x))]
    got = tbases.airy_basis(n, torch.as_tensor(x))
    assert got.value.dtype == torch.float64
    _triples(got, want, atol=1e-12)


@pytest.mark.parametrize("n", [0, 3])
def test_airy_basis_f32(n):
    x = np.random.default_rng(10 + n).uniform(0.0, 35.0, 200).astype(np.float32)
    want = [np.asarray(a) for a in jbases.airy_basis(n, jnp.asarray(x))]
    got = tbases.airy_basis(n, torch.as_tensor(x))
    assert got.value.dtype == torch.float32
    for a, b in zip(got, want):
        a, b = a.numpy().reshape(-1), b.reshape(-1)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.max(np.abs(b)))


def test_airy_table_is_built_once_per_device():
    assert tbases.airy_table("cpu") is tbases.airy_table("cpu")
    ai, aip, dz = tbases._airy_knots()
    assert ai.dtype == np.float32 and ai.shape == (16384,)
    j = jbases._get_airy_table()
    np.testing.assert_array_equal(ai, np.asarray(j.ai))
    np.testing.assert_array_equal(aip, np.asarray(j.aip))
    assert dz == j.dz


@pytest.mark.parametrize("d", [1, 2, 3])
def test_box_sine_factor(d):
    """Includes points on the sine nodes (the box walls), where the
    per-dimension gradient must stay exact."""
    x = np.random.default_rng(d).uniform(-1.0, 2.0, (40, d))
    x[0] = -1.0
    x[1, 0] = 2.0
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jans.box_sine_factor(-1.0, 2.0)(jnp.asarray(x))]
    _triples(tans.box_sine_factor(-1.0, 2.0)(torch.as_tensor(x)), want)


def _net(layers, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0.0, 1.0 / np.sqrt(i), (i, o)), rng.normal(0.0, 0.1, o))
            for i, o in zip(layers[:-1], layers[1:])]


@pytest.mark.parametrize("kind", ["hard_bc", "perturbation_hard_bc", "perturbation"])
def test_ansatz_triples(kind):
    """The hard-BC and perturbation compositions over the same net, 2D."""
    p = _net((2, 12, 12, 1), 3)
    x = np.random.default_rng(4).uniform(0.0, 1.0, (50, 2))
    act = "shifted_tanh"
    with jax.enable_x64(True):
        jp = [(jnp.asarray(w), jnp.asarray(b)) for w, b in p]
        jvgl = lambda q, y: jmlp.mlp_vgl(q, y, act)
        jval = lambda q, y: jmlp.mlp_apply(q, y, act)
        jbase = lambda y: jbases.box_basis_2d(1, 0, y)
        inner = (jans.plain_ansatz(jvgl, jval) if kind == "perturbation"
                 else jans.hard_bc_ansatz(jvgl, jval, jans.box_sine_factor(0.0, 1.0)))
        a = inner if kind == "hard_bc" else jans.perturbation_ansatz(inner, jbase)
        want = [np.asarray(v) for v in a.vgl(jp, jnp.asarray(x), 0.03)]
        want_val = np.asarray(a.value(jp, jnp.asarray(x), 0.03))
    tp = tmlp.params_from_numpy(p, device="cpu", dtype=torch.float64)
    tvgl = lambda q, y: tmlp.mlp_vgl(q, y, act)
    tval = lambda q, y: tmlp.mlp_apply(q, y, act)
    tbase = lambda y: tbases.box_basis_2d(1, 0, y)
    inner = (tans.plain_ansatz(tvgl, tval) if kind == "perturbation"
             else tans.hard_bc_ansatz(tvgl, tval, tans.box_sine_factor(0.0, 1.0)))
    a = inner if kind == "hard_bc" else tans.perturbation_ansatz(inner, tbase)
    tx = torch.as_tensor(x)
    _triples(a.vgl(tp, tx, 0.03), want)
    _close(a.value(tp, tx, 0.03), want_val)


def test_disk_geometry_is_bit_equal():
    c, r = (1.5707963267948966, 1.5707963267948966), 1.5707963267948966
    for tf, jf, args in ((tgeo.disk_points, jgeo.disk_points, (c, r, 1000)),
                         (tgeo.circle_points, jgeo.circle_points, (c, r, 500)),
                         (tgeo.disk_weights, jgeo.disk_weights, (r, 1000))):
        got = tf(*args, device="cpu").numpy()
        want = np.asarray(jf(*args))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _arrays(n=256, d=2, seed=0):
    """A positive u (a ground state's sign), so no sum cancels: the f32
    sums of the JAX package then hold a relative error, not an absolute one
    at the scale of Σ|terms|; ∫u²w ≈ 5, away from the norm term's 1."""
    rng = np.random.default_rng(seed)
    return dict(u=rng.uniform(0.2, 1.0, n), grad=rng.normal(0.0, 0.5, (n, d)),
                lap=rng.normal(0.0, 1.0, n), bv=rng.normal(0.0, 0.1, 16),
                V=rng.uniform(0.0, 5.0, n), w=np.full(n, 0.05),
                ur=rng.uniform(0.2, 1.0, n), x2=rng.uniform(0.0, 9.0, n))


def test_rayleigh_and_quadrature_reductions():
    a = _arrays()
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    gamma, mu = 3.0, 1.7
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in a.items()}
        want = [jray.rayleigh_mu(j["u"], j["lap"], j["V"], gamma, 3.0, 0.5, "power"),
                jray.riesz_energy(j["u"], j["grad"], j["V"], j["w"], gamma, 3.0, 0.5),
                jray.riesz_energy(j["u"], j["grad"], j["V"], j["w"], gamma, 4.0, 1.0,
                                  normalize=False),
                jquad.integrate(j["u"], j["w"]), jquad.wmean(j["V"])]
        want = [float(v) for v in want]
        res = np.asarray(jray.gpe_residual(j["u"], j["lap"], j["V"], mu, gamma, 3.0,
                                           0.5, "abs_power"))
    got = [tray.rayleigh_mu(t["u"], t["lap"], t["V"], gamma, 3.0, 0.5, "power"),
           tray.riesz_energy(t["u"], t["grad"], t["V"], t["w"], gamma, 3.0, 0.5),
           tray.riesz_energy(t["u"], t["grad"], t["V"], t["w"], gamma, 4.0, 1.0,
                             normalize=False),
           tquad.integrate(t["u"], t["w"]), tquad.wmean(t["V"])]
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), w, rtol=SUMS)
    _close(tray.gpe_residual(t["u"], t["lap"], t["V"], mu, gamma, 3.0, 0.5,
                             "abs_power"), res)


TERM_CASES = {
    "l2_norm": dict(norm_style="l2"),
    "even": dict(symmetry="even"),
    "odd": dict(symmetry="odd"),
    "interval": dict(symmetry="interval"),
    "riesz": dict(use_riesz=True),
    "width": dict(width_penalty=True),
    "anti_trivial": dict(anti_trivial=True, anti_trivial_c=1.5),
    "report_shift": dict(mu_report_shift=2.0),
    "all": dict(norm_style="l2", symmetry="odd", use_riesz=True, width_penalty=True,
                anti_trivial=True, mu_report_shift=1.0, nonlinearity="power"),
}


@pytest.mark.parametrize("case", sorted(TERM_CASES))
def test_gpe_terms(case):
    kw = dict(p=3.0, kinetic=0.5, **TERM_CASES[case])
    a = _arrays(seed=len(case))
    gamma = 4.0
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in a.items()}
        out = jgpe.gpe_terms(j["u"], j["grad"], j["lap"], j["bv"], j["V"], j["w"],
                             gamma, jgpe.GPETerms(**kw), u_reflect=j["ur"], x2=j["x2"])
        want = {k: float(v) for k, v in out.losses.items()}
        want_mu = float(out.mu)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    got = tgpe.gpe_terms(t["u"], t["grad"], t["lap"], t["bv"], t["V"], t["w"], gamma,
                         tgpe.GPETerms(**kw), u_reflect=t["ur"], x2=t["x2"])
    assert sorted(got.losses) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got.losses[k]), v, rtol=SUMS, err_msg=k)
    np.testing.assert_allclose(float(got.mu), want_mu, rtol=SUMS)


BATCH_SPECS = {
    "disk": dict(dim=2, lb=0.0, ub=3.141592653589793, n_points=20, geometry="disk",
                 n_boundary=50, layers=(2, 16, 1), potential="gaussian",
                 potential_kwargs=(("V0", 1.0), ("center", (1.5707963267948966,
                                                            1.5707963267948966)),
                                   ("sigma", 0.5)),
                 kinetic=0.5, nonlinearity="abs_power", use_perturbation=False),
    "disk_perturbation": dict(dim=2, lb=-4.0, ub=4.0, n_points=16, geometry="disk",
                              radius=3.0, center=(0.5, -0.5), n_boundary=40,
                              layers=(2, 16, 1)),
    "even": dict(n_points=101, layers=(1, 16, 1), symmetry="even", sym_weight=1.0),
    "odd_box": dict(lb=0.0, ub=1.0, n_points=64, layers=(1, 16, 1), basis="box",
                    potential="box", hard_bc=True, symmetry="odd", sym_weight=1.0),
    "interval_airy": dict(lb=0.0, ub=35.0, n_points=128, layers=(1, 16, 1),
                          basis="airy", potential="linear", symmetry="interval",
                          sym_weight=1.0),
    "y_even": dict(dim=2, lb=-6.0, ub=6.0, n_points=12, layers=(2, 16, 1),
                   symmetry="y_even", sym_weight=500.0, use_perturbation=False),
}


@pytest.mark.parametrize("name", sorted(BATCH_SPECS))
def test_make_batch_disk_and_symmetries(name):
    """In f64 on both sides (the JAX package under x64): an f32 batch of the
    JAX package is built from the f32 grid, the port's from the f64 grid and
    rounded once, so f32 batches differ by the JAX side's f32 evaluation
    error (2.7e-6 at the Airy base's zero) and tests/test_torch_physics.py
    holds the f32 casts."""
    kw = BATCH_SPECS[name]
    with jax.enable_x64(True):
        want = {k: np.asarray(v) for k, v in
                jprob.make_batch(jprob.GPESpec(**kw, dtype=jnp.float64), 1).items()}
    got = tprob.make_batch(tprob.GPESpec(**kw, dtype=torch.float64), 1, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float64
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=F64, atol=1e-12,
                                   err_msg=k)
