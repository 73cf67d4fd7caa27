"""Port parity in three dimensions, the non-slow tests of tests/test_3d.py
held against the JAX package: the Hermite product basis against the JAX
package and autodiff, the 3D batch and its faces, μ of the base at γ = 0,
the plain K1 and K2 at d = 3 against the JAX package's Pallas kernels in
interpret mode, the split-step oracle at γ = 0 and the Thomas–Fermi
anchor. tests/test_torch_3d_flow.py holds the 3D loss, the flow solver
and the 3D flagship driver.

Tolerances: f64 values at rtol 1e-12 (bases, the TF anchor) and 1e-10
(the oracle's μ and ψ); the batch in f32 at 1e-6; μ at the base at rtol
1e-6; the kernels' plain versions at tests/test_pallas*.py's f32 bounds
(loss rtol 2e-5, μ 1e-5, gradients normalised 2e-4).
"""
import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.ops.laplacian import value_grad_lap_generic  # noqa: E402
from gpe_tpu.pallas.fused_grad import make_pallas_value_and_grad  # noqa: E402
from gpe_tpu.pallas.fused_residual import make_pallas_loss_eval  # noqa: E402
from gpe_tpu.physics import bases as jbases  # noqa: E402
from gpe_tpu.physics.thomas_fermi import thomas_fermi_mu_3d_harmonic as j_tf3  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu.validate.imaginary_time import imaginary_time_gpe as j_itime  # noqa: E402
from gpe_tpu_torch.kernels import fused_grad as k2  # noqa: E402
from gpe_tpu_torch.kernels import fused_residual as k1  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.physics import bases as tbases  # noqa: E402
from gpe_tpu_torch.physics.thomas_fermi import thomas_fermi_mu_3d_harmonic as t_tf3  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402
from gpe_tpu_torch.train.loop import value_and_grad  # noqa: E402
from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe as t_itime  # noqa: E402

FLAGSHIP3 = dict(dim=3, lb=-6.0, ub=6.0, n_points=36, layers=(3, 128, 128, 128, 1),
                 potential="harmonic", potential_kwargs=(("a", 0.5),), basis="hermite",
                 kinetic=0.5, nonlinearity="abs_power", use_perturbation=False)


def _spec3d(n=8, width=16, **kw):
    return dict(dim=3, lb=-6.0, ub=6.0, n_points=n, layers=(3, width, width, 1),
                activation="tanh", potential="harmonic", potential_kwargs=(("a", 0.5),),
                basis="hermite", kinetic=0.5, nonlinearity="abs_power", **kw)


def test_hermite_product_nd_matches_jax_and_autodiff():
    """Value/∇/Δ of φ₁(x)φ₀(y)φ₂(z): the port against the JAX package (f64)
    and against JAX's generic jvp-of-grad oracle; the nd product in 2D
    against hermite_product_2d."""
    x = np.random.default_rng(0).uniform(-2.0, 2.0, (64, 3))
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jbases.hermite_product_nd((1, 0, 2), jnp.asarray(x))]

        def f(pt):
            return (jbases.hermite_basis(1, pt[0:1]).value[0]
                    * jbases.hermite_basis(0, pt[1:2]).value[0]
                    * jbases.hermite_basis(2, pt[2:3]).value[0])

        auto = [np.asarray(a) for a in value_grad_lap_generic(f, jnp.asarray(x))]
    got = tbases.hermite_product_nd((1, 0, 2), torch.as_tensor(x))
    for g, w, a in zip(got, want, auto):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-9, atol=1e-10)
    xy = torch.as_tensor(x[:, :2])
    for a, b in zip(tbases.hermite_product_nd((2, 1), xy), tbases.hermite_product_2d(2, 1, xy)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-13)


def test_make_batch_3d_matches_jax_and_faces():
    kw = _spec3d(use_perturbation=True)
    want = jprob.make_batch(jprob.GPESpec(**kw), 0)
    spec = tprob.GPESpec(**kw)
    got = tprob.make_batch(spec, 0, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    n = spec.n_points ** 3
    assert got["x"].shape == (n, 3) and got["w"].shape == (n,)
    bx = got["bx"].numpy()
    on_face = np.isclose(bx, spec.lb) | np.isclose(bx, spec.ub)
    assert on_face.any(axis=1).all()
    for axis in range(3):
        assert on_face[:, axis].any()
    dx = (spec.ub - spec.lb) / (spec.n_points - 1)
    np.testing.assert_allclose(got["w"].numpy()[0], dx ** 3, rtol=1e-6)


def test_loss_fn_3d_gamma0_mu_at_base():
    """Zero perturbation at γ = 0: μ is the 3D ladder 1.5 + mode, as the
    JAX package reads it."""
    kw = _spec3d(n=14, use_perturbation=True)
    jspec, tspec = jprob.GPESpec(**kw), tprob.GPESpec(**kw)
    jzero = jax.tree.map(jnp.zeros_like, jmlp.init_mlp(jax.random.PRNGKey(0), jspec.layers))
    tzero = params_from_numpy(jax.tree.map(np.asarray, jzero), device="cpu")
    for mode in (0, 1, 2):
        _, jaux = jprob.make_loss_fn(jspec)(jzero, jprob.make_batch(jspec, mode),
                                            jnp.float32(0.0), jnp.float32(0.0))
        _, taux = tprob.make_loss_fn(tspec)(tzero, tprob.make_batch(tspec, mode, device="cpu"),
                                            torch.tensor(0.0), torch.tensor(0.0))
        np.testing.assert_allclose(float(taux["mu"]), 1.5 + mode, atol=5e-3)
        np.testing.assert_allclose(float(taux["mu"]), float(jaux["mu"]), rtol=1e-6)


def _kernel_case():
    kw = _spec3d(n=8, width=32, use_perturbation=True)
    kw["layers"] = (3, 32, 32, 1)
    jspec, tspec = jprob.GPESpec(**kw), tprob.GPESpec(**kw)
    jparams = jmlp.init_mlp(jax.random.PRNGKey(1), jspec.layers)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jbatch = jprob.make_batch(jspec, 0)
    tbatch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    phys = lambda s: (s.layers, s.activation, s.p, s.kinetic, s.nonlinearity)
    return jspec, tspec, jparams, tparams, jbatch, tbatch, phys


def test_plain_k1_3d_matches_pallas_interpret():
    jspec, tspec, jparams, tparams, jbatch, tbatch, phys = _kernel_case()
    ev = make_pallas_loss_eval(*phys(jspec), bc_weight=jspec.bc_weight,
                               norm_weight=jspec.norm_weight, tile=128, interpret=True)
    p_tot, p_aux = ev(jparams, jbatch, 5.0, 0.01)
    tot, aux = k1.make_loss_eval(*phys(tspec), bc_weight=tspec.bc_weight,
                                 norm_weight=tspec.norm_weight)(tparams, tbatch, 5.0, 0.01)
    np.testing.assert_allclose(float(tot), float(p_tot), rtol=2e-5)
    np.testing.assert_allclose(float(aux["mu"]), float(p_aux["mu"]), rtol=2e-5)


def test_plain_k2_3d_matches_pallas_interpret():
    """tests/test_3d.py:89: K2 at d = 3 (interpret mode) against the plain
    version of the port's kernel, and both against autodiff."""
    jspec, tspec, jparams, tparams, jbatch, tbatch, phys = _kernel_case()
    g, s = jnp.float32(5.0), jnp.float32(0.01)
    pvag = make_pallas_value_and_grad(*phys(jspec), bc_weight=jspec.bc_weight,
                                      norm_weight=jspec.norm_weight, tile=128,
                                      sum_tile=256, interpret=True)
    (p_tot, p_aux), p_grads = pvag(jparams, jbatch, g, s)
    (tot, aux), grads = k2.make_value_and_grad(*phys(tspec), bc_weight=tspec.bc_weight,
                                               norm_weight=tspec.norm_weight)(
        tparams, tbatch, 5.0, 0.01)
    (a_tot, _), a_grads = value_and_grad(tprob.make_loss_fn(tspec))(
        tparams, tbatch, torch.tensor(5.0), torch.tensor(0.01))
    np.testing.assert_allclose(float(tot), float(p_tot), rtol=1e-5)
    np.testing.assert_allclose(float(aux["mu"]), float(p_aux["mu"]), rtol=1e-5)
    np.testing.assert_allclose(float(tot), float(a_tot), rtol=1e-5)
    for ref in (p_grads, a_grads):
        for (gw, gb), (rw, rb) in zip(grads, ref):
            for a, b in ((gw, rw), (gb, rb)):
                b = np.asarray(b)
                sc = np.abs(b).max() + 1e-12
                np.testing.assert_allclose(a.numpy() / sc, b / sc, atol=2e-4)


def test_imaginary_time_3d_gamma0_matches_jax():
    """μ = 1.5 and the isotropic Gaussian at γ = 0 (32³ periodic grid), the
    same μ and ψ as the JAX package's oracle."""
    n = 32
    x1 = np.linspace(-6.0, 6.0, n, endpoint=False)
    X, Y, Z = np.meshgrid(x1, x1, x1, indexing="ij")
    V = 0.5 * (X ** 2 + Y ** 2 + Z ** 2)
    kw = dict(kinetic=0.5, tau=5e-3, steps=3000)
    mu, psi = t_itime(V, x1[1] - x1[0], 0.0, device="cpu", **kw)
    jmu, jpsi = j_itime(V, x1[1] - x1[0], 0.0, **kw)
    assert abs(mu - 1.5) < 1e-6
    np.testing.assert_allclose(mu, jmu, rtol=1e-10)
    np.testing.assert_allclose(psi.numpy(), jpsi, rtol=0, atol=1e-10)


def test_thomas_fermi_mu_3d_matches_jax():
    for gamma in (5.0, 100.0):
        for a in (0.5, 1.0):
            np.testing.assert_allclose(float(t_tf3(gamma, a)), float(j_tf3(gamma, a)),
                                       rtol=1e-12)


