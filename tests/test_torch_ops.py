"""Port parity: the activation registries and the forward-Laplacian MLP
against the JAX package (f64, rtol 1e-12 / 1e-10) and against a torch.func
jvp-of-grad oracle (the twin of tests/test_ops.py's autodiff check)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.ops import laplacian as jlap  # noqa: E402
from gpe_tpu_torch.models.mlp import mlp_apply, params_from_numpy  # noqa: E402
from gpe_tpu_torch.ops import laplacian as tlap  # noqa: E402


def _np_params(layers, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0.0, 1.0 / np.sqrt(k), (k, m)), rng.normal(0.0, 0.1, m))
            for k, m in zip(layers[:-1], layers[1:])]


@pytest.mark.parametrize("name", sorted(jlap.ACTIVATIONS))
def test_activation_triples(name):
    y = np.random.default_rng(0).normal(0.0, 2.0, 200)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jlap.ACTIVATIONS[name](jnp.asarray(y))]
    for a, b in zip(tlap.ACTIVATIONS[name](torch.as_tensor(y)), want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("name", sorted(jlap.ACTIVATION_QUADS))
def test_activation_quads(name):
    y = np.random.default_rng(1).normal(0.0, 2.0, 200)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jlap.ACTIVATION_QUADS[name](jnp.asarray(y))]
    for a, b in zip(tlap.ACTIVATION_QUADS[name](torch.as_tensor(y)), want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("name", sorted(jlap.ACTIVATION_FROM_VALUES))
def test_activation_from_values(name):
    rng = np.random.default_rng(2)
    s0, s1 = rng.uniform(-1.0, 2.0, 100), rng.uniform(0.0, 1.0, 100)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in
                jlap.ACTIVATION_FROM_VALUES[name](jnp.asarray(s0), jnp.asarray(s1))]
    got = tlap.ACTIVATION_FROM_VALUES[name](torch.as_tensor(s0), torch.as_tensor(s1))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-13)


def test_registries_have_the_same_keys():
    assert set(tlap.ACTIVATIONS) == set(jlap.ACTIVATIONS)
    assert set(tlap.ACTIVATION_QUADS) == set(jlap.ACTIVATION_QUADS)
    assert set(tlap.ACTIVATION_FROM_VALUES) == set(jlap.ACTIVATION_FROM_VALUES)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("activation", ["tanh", "shifted_tanh", "sin", "gelu"])
def test_fwdlap_matches_jax(d, activation):
    layers = (d, 24, 16, 1)
    p = _np_params(layers, d)
    x = np.random.default_rng(10 + d).normal(0.0, 1.5, (40, d))
    with jax.enable_x64(True):
        want = jlap.fwdlap_mlp([(jnp.asarray(w), jnp.asarray(b)) for w, b in p],
                               jnp.asarray(x), activation)
        want = [np.asarray(a) for a in want]
    got = tlap.fwdlap_mlp(params_from_numpy(p, device="cpu", dtype=torch.float64),
                          torch.as_tensor(x), activation)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-12)


def _jvp_of_grad(params, x, activation):
    """(f, ∇f, Δf) per point by torch.func: grad, then jvp along each axis."""
    from torch.func import grad, jvp, vmap

    def f(pt):
        return mlp_apply(params, pt[None, :], activation)[0]

    def one(pt):
        g = grad(f)(pt)
        lap = sum(jvp(grad(f), (pt,), (torch.eye(pt.shape[0], dtype=pt.dtype)[i],))[1][i]
                  for i in range(pt.shape[0]))
        return f(pt), g, lap

    return vmap(one)(x)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("activation", ["tanh", "shifted_tanh", "sin", "gelu"])
def test_fwdlap_matches_autodiff_oracle(d, activation):
    params = params_from_numpy(_np_params((d, 16, 16, 1), 20 + d),
                               device="cpu", dtype=torch.float64)
    x = torch.as_tensor(np.random.default_rng(30 + d).normal(0.0, 1.0, (32, d)))
    got = tlap.fwdlap_mlp(params, x, activation)
    val, g, lap = _jvp_of_grad(params, x, activation)
    np.testing.assert_allclose(got.value.numpy(), val.numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got.grad.numpy(), g.numpy(), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(got.lap.numpy(), lap.numpy(), rtol=1e-10, atol=1e-11)
