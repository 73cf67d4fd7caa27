"""Port parity of K4 (the channel-stacked fused eval, kernels/rowcat_eval.py)
and of K1's bf16 operand mode: their plain versions on the CPU against the
JAX package's Pallas kernels in interpret mode, on the same inputs.

Tolerances: f32 rtol 2e-5 on total and μ (tests/test_pallas.py's, other
summation orders). bf16 operands: both sides round the same operands to bf16
(nearest even) and sum in f32, so they agree far inside the 3e-2 that
tests/test_pallas.py allows bf16 against f32; an f32 value within f32
round-off of a bf16 rounding boundary may still round the other way on the
two sides, so the bound is rtol 1e-3 on total and μ. The four collocation
sums are held at BF16_SUMS_RTOL = 1e-4 (the port is 4e-6 or closer here),
below the 1.6e-4–1.2e-2 by which the f32 sums miss the bf16 ones at these
shapes, so an f32 path or a mode that rounds the wrong operands fails.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.pallas.fused_residual import make_pallas_loss_eval  # noqa: E402
from gpe_tpu.pallas.rowcat_eval import make_rowcat_loss_eval as jax_rowcat  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.kernels import fused_residual as k1  # noqa: E402
from gpe_tpu_torch.kernels import rowcat_eval as k4  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402

SPEC_2D = dict(dim=2, n_points=32, layers=(2, 100, 100, 100, 1),
               potential="harmonic", potential_kwargs=(("a", 0.5),), kinetic=0.5,
               lb=-6.0, ub=6.0, nonlinearity="abs_power", use_perturbation=False,
               activation="tanh")
SPEC_1D_PERT = dict(dim=1, n_points=1024, layers=(1, 64, 64, 64, 1),
                    potential="harmonic", lb=-10.0, ub=10.0, nonlinearity="power",
                    use_perturbation=True, basis="hermite", activation="shifted_tanh")
# tests/test_pallas.py:88-112's three rowcat shapes: (spec, γ, s, tile, bf16)
CASES = {"2d_f32": (SPEC_2D, 10.0, 0.01, 256, False),
         "1d_perturbation_f32": (SPEC_1D_PERT, 3.0, 0.01, 512, False),
         "2d_bf16": (SPEC_2D, 10.0, 0.01, 256, True)}
BF16_SUMS_RTOL = 1e-4


def _setup(kw):
    spec = jprob.GPESpec(**kw)
    jparams = jmlp.init_mlp(jax.random.PRNGKey(0), spec.layers)
    jbatch = jprob.make_batch(spec, 0)
    tparams = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jparams],
                                device="cpu")
    tbatch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    return spec, jparams, jbatch, tparams, tbatch


def _phys(spec):
    return (spec.layers, spec.activation, spec.p, spec.kinetic, spec.nonlinearity)


def _sums(ev, params, batch, gamma, scale):
    return np.array(ev.collocation_sums(params, batch["x"], batch["V"], batch["w"],
                                        gamma, scale, batch.get("base_val"),
                                        batch.get("base_lap")))


def _close(got, want, rtol):
    tot, aux = got
    jtot, jaux = want
    np.testing.assert_allclose(float(tot), float(jtot), rtol=rtol)
    np.testing.assert_allclose(float(aux["mu"]), float(jaux["mu"]), rtol=rtol)
    for key in ("pde", "boundary", "norm"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=rtol,
                                   atol=1e-8, err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_k4_eval_matches_jax_rowcat_interpret(name):
    kw, gamma, scale, tile, bf16 = CASES[name]
    spec, jparams, jbatch, tparams, tbatch = _setup(kw)
    weights = dict(bc_weight=spec.bc_weight, norm_weight=spec.norm_weight, tile=tile)
    jev = jax_rowcat(*_phys(spec), **weights, interpret=True,
                     compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tev = k4.make_rowcat_loss_eval(*_phys(spec), **weights,
                                   compute_dtype=torch.bfloat16 if bf16
                                   else torch.float32)
    _close(tev(tparams, tbatch, gamma, scale), jev(jparams, jbatch, gamma, scale),
           1e-3 if bf16 else 2e-5)
    tsums = _sums(tev, tparams, tbatch, gamma, scale)
    assert tsums.shape == (4,)
    np.testing.assert_allclose(tsums, _sums(jev, jparams, jbatch, gamma, scale),
                               rtol=BF16_SUMS_RTOL if bf16 else 2e-5)


@pytest.mark.parametrize("name", ["2d_bf16", "1d_perturbation_f32"])
def test_k1_bf16_plain_matches_jax_interpret(name):
    """K1's bf16 operand mode (plain version on the CPU) against
    make_pallas_loss_eval(compute_dtype=bf16, interpret=True)."""
    kw, gamma, scale, tile, _ = CASES[name]
    spec, jparams, jbatch, tparams, tbatch = _setup(kw)
    weights = dict(bc_weight=spec.bc_weight, norm_weight=spec.norm_weight)
    jev = make_pallas_loss_eval(*_phys(spec), **weights, tile=tile, interpret=True,
                                compute_dtype=jnp.bfloat16)
    tev = k1.make_loss_eval(*_phys(spec), **weights, compute_dtype=torch.bfloat16)
    _close(tev(tparams, tbatch, gamma, scale), jev(jparams, jbatch, gamma, scale), 1e-3)
    jsums = _sums(jev, jparams, jbatch, gamma, scale)
    port = lambda dt: k1.collocation_sums(
        tparams, tbatch["x"], tbatch["V"], tbatch["w"], gamma, scale,
        tbatch.get("base_val"), tbatch.get("base_lap"), *_phys(spec)[1:],
        compute_dtype=dt).numpy()
    np.testing.assert_allclose(port(torch.bfloat16), jsums, rtol=BF16_SUMS_RTOL)
    f32 = port(torch.float32)
    assert np.max(np.abs(f32 - jsums) / np.abs(jsums)) > BF16_SUMS_RTOL


def test_bf16_plain_rounds_every_gemm_operand():
    """fwdlap_mlp_bf16 moves the value of a general net off fwdlap_mlp's
    by bf16 round-off, and on a one-hidden-layer net it is exactly the
    forward pass with x, W0, the hidden state and the last W rounded."""
    rng = np.random.default_rng(0)
    layers = (2, 16, 16, 1)
    raw = [(rng.normal(0, 0.5, (k, m)), rng.normal(0, 0.1, m))
           for k, m in zip(layers[:-1], layers[1:])]
    params = params_from_numpy(raw, device="cpu")
    x = torch.as_tensor(rng.uniform(-2, 2, (50, 2)), dtype=torch.float32)
    a = k1.fwdlap_mlp_bf16(params, x, "tanh")
    b = k1.fwdlap_mlp(params, x, "tanh")
    assert not torch.equal(a.value, b.value)
    np.testing.assert_allclose(a.value.numpy(), b.value.numpy(), rtol=0.05, atol=0.02)
    p1 = tuple((w.to(torch.bfloat16).float(), bb) for w, bb in params_from_numpy(
        raw[:1] + [(rng.normal(0, 0.5, (16, 1)), rng.normal(0, 0.1, 1))], device="cpu"))
    x16 = x.to(torch.bfloat16).float()
    got = k1.fwdlap_mlp_bf16(p1, x16, "tanh")
    z = x16 @ p1[0][0] + p1[0][1]
    want = torch.tanh(z).to(torch.bfloat16).float() @ p1[1][0][:, 0] + p1[1][1][0]
    np.testing.assert_allclose(got.value.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_k4_refuses_what_it_does_not_take():
    """JAX's asserts become ValueErrors: a count the tile does not divide,
    non-scalar output, no hidden layer, widths over 128; and the run mode
    has no bf16 mode."""
    spec, _, _, tparams, tbatch = _setup(SPEC_2D)
    ev = k4.make_rowcat_loss_eval(*_phys(spec), tile=1000)
    with pytest.raises(ValueError, match="divisible by tile=1000"):
        ev(tparams, tbatch, 10.0, 0.01)
    with pytest.raises(ValueError, match="divisible"):
        ev.collocation_sums(tparams, tbatch["x"], tbatch["V"], tbatch["w"], 1.0, 1.0)
    for layers, match in (((2, 32, 2), "scalar-output"), ((2, 1), "hidden layer"),
                          ((2, 130, 1), "<= 128")):
        with pytest.raises(ValueError, match=match):
            k4.make_rowcat_loss_eval(layers)
    with pytest.raises(ValueError, match="compute_dtype"):
        k4.make_rowcat_loss_eval((2, 8, 1), compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 only"):
        k1.make_loss_eval((2, 8, 1), runs=True, compute_dtype=torch.bfloat16)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    spec, _, _, tparams, tbatch = _setup(SPEC_1D_PERT)
    k4.collocation_sums.launches = k4.collocation_sums.bf16_launches = 0
    k1.collocation_sums.bf16_launches = 0
    args = (tparams, tbatch["x"], tbatch["V"], tbatch["w"], 3.0, 0.01,
            tbatch["base_val"], tbatch["base_lap"], spec.activation, spec.p,
            spec.kinetic, spec.nonlinearity)
    for dt in (torch.float32, torch.bfloat16):
        got = k4.collocation_sums(*args, compute_dtype=dt)
        assert torch.equal(got, k4.collocation_sums_plain(*args, compute_dtype=dt))
        assert torch.equal(got, k1.collocation_sums(*args, compute_dtype=dt))
    assert k4.collocation_sums.launches == k4.collocation_sums.bf16_launches == 0
    assert k1.collocation_sums.bf16_launches == 0
