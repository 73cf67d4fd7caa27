"""K2's bf16 operand mode (`kernels/fused_grad.py`, compute_dtype=
torch.bfloat16) against the JAX package's `make_pallas_value_and_grad(...,
compute_dtype=jnp.bfloat16)` in interpret mode, on the four cases of
tests/test_torch_kernels.py: the exact vag, the relaxed vag over four steps,
the run mode against JAX's n_runs = 2, and fit(value_and_grad_fn=).

The bound: gradients normalised per leaf (max|Δ| / max|JAX|) ≤ 2e-4. JAX's
own bf16 and f32 modes sit 1.2e-3 (1d_perturbation) to 1.9e-2
(2d_vanilla_tanh) apart on these inputs, 2.4e-3 at 2d_perturbation
(measured on the CPU); the port's plain version meets JAX's bf16 mode to
1.5e-6–3.9e-5. So 2e-4 sits 6x under the smallest gap and 5x over the
largest reading: it tells the bf16 mode from f32, and from the planted
fault below (6.2e-3–2.3e-2), which autograd over K1-bf16's sums would be.
Totals and μ: rtol 3e-5 (the power nonlinearity's total reads 1.0e-5, μ
at 2d_vanilla_tanh 1.4e-5; both come from K1-bf16's sums).
"""
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.pallas import packing as jpack  # noqa: E402
from gpe_tpu.pallas.fused_grad import make_pallas_value_and_grad  # noqa: E402
from gpe_tpu.train import loop as jloop  # noqa: E402
from gpe_tpu.train import plpinn as jpl  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.kernels import fused_grad as k2  # noqa: E402
from gpe_tpu_torch.kernels import fused_residual as k1  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import loop as tloop  # noqa: E402
from gpe_tpu_torch.train import plpinn as tpl  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_kernels import CASES, _phys, _setup  # noqa: E402

BF16 = torch.bfloat16
GRAD_TOL = 2e-4
VAL_RTOL = 3e-5


def _norm_err(got, want) -> float:
    """max over leaves (and runs) of max|Δ| / max|want|."""
    worst = 0.0
    for (gw, gb), (ww, wb) in zip(got, want):
        for a, b in ((gw, ww), (gb, wb)):
            a, b = np.asarray(a), np.asarray(b)
            a, b = a.reshape(-1, a.shape[-1]) if a.ndim > 2 else a, b
            worst = max(worst, float(np.max(np.abs(a - b.reshape(a.shape)))
                                     / (np.max(np.abs(b)) + 1e-30)))
    return worst


def _jvag(jspec, tile, **kw):
    return make_pallas_value_and_grad(*_phys(jspec), bc_weight=jspec.bc_weight,
                                      norm_weight=jspec.norm_weight, tile=tile,
                                      sum_tile=tile, interpret=True,
                                      compute_dtype=jnp.bfloat16, **kw)


def _tvag(tspec, **kw):
    return k2.make_value_and_grad(*_phys(tspec), bc_weight=tspec.bc_weight,
                                  norm_weight=tspec.norm_weight, compute_dtype=BF16,
                                  **kw)


def _k1_autograd_fault(tspec, tparams, tbatch, gamma, scale, grads):
    """The vag's gradient with its collocation part replaced by autograd over
    K1-bf16's plain sums (weights rounded in the forward, cotangents passed
    through the roundings unrounded): the recipe the bf16 mode is not."""
    kw = (tspec.activation, tspec.p, tspec.kinetic, tspec.nonlinearity)
    args = (tbatch["x"], tbatch["V"], tbatch["w"], gamma, scale,
            tbatch.get("base_val"), tbatch.get("base_lap"))
    sums = k1.collocation_sums(tparams, *args, *kw, compute_dtype=BF16)
    cots = k1.sums_to_loss(sums, args[0].shape[0], tspec.norm_weight)[3]
    fault, _ = k2._autograd_grads(
        lambda prm, *a: k1.collocation_sums_plain(prm, *a, compute_dtype=BF16),
        tparams, args + kw, cots)
    own, _ = k2.collocation_grads(tparams, *args[:5], cots, *args[5:], *kw,
                                  compute_dtype=BF16)
    return tuple((gw - ow + fw, gb - ob + fb)
                 for (gw, gb), (ow, ob), (fw, fb) in zip(grads, own, fault))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_exact_vag_matches_jax_and_the_k1_autograd_recipe_does_not(name):
    jspec, tspec, jparams, tparams, jbatch, tbatch, gamma, scale, tile = _setup(name)
    (jt, jaux), jg = _jvag(jspec, tile)(jparams, jbatch, jnp.float32(gamma),
                                        jnp.float32(scale))
    (tt, taux), tg = _tvag(tspec)(tparams, tbatch, gamma, scale)
    np.testing.assert_allclose(float(tt), float(jt), rtol=VAL_RTOL)
    np.testing.assert_allclose(float(taux["mu"]), float(jaux["mu"]), rtol=VAL_RTOL)
    assert _norm_err(tg, jg) <= GRAD_TOL
    # the bound tells the bf16 mode from f32: the port's f32 vag (JAX's f32
    # to 2e-4, tests/test_torch_kernels.py) lies well outside it
    _, fg = k2.make_value_and_grad(*_phys(tspec), bc_weight=tspec.bc_weight,
                                   norm_weight=tspec.norm_weight)(tparams, tbatch,
                                                                  gamma, scale)
    assert _norm_err(fg, jg) > 5 * GRAD_TOL
    fault = _k1_autograd_fault(tspec, tparams, tbatch, gamma, scale, tg)
    assert _norm_err(fault, jg) > 10 * GRAD_TOL


def test_bf16_relaxed_vag_matches_jax_over_steps():
    """delayed + fresh_values + extrapolate + refresh_every=2 (step 2 runs
    K1-bf16), four steps from the same param sequence on both sides."""
    jspec, tspec, jparams, tparams, jbatch, tbatch, gamma, scale, tile = \
        _setup("2d_perturbation")
    g, s = jnp.float32(gamma), jnp.float32(scale)
    modes = dict(delayed=True, fresh_values=True, extrapolate=True, refresh_every=2)
    pvag, tvag = _jvag(jspec, tile, **modes), _tvag(tspec, **modes)
    jst = pvag.init_state(jparams, jbatch, g, s)
    tst = tvag.init_state(tparams, tbatch, gamma, scale)
    for step in range(4):
        (jt, jaux), jg, jst = pvag(jparams, jbatch, g, s, jst)
        (tt, taux), tg, tst = tvag(tparams, tbatch, gamma, scale, tst)
        np.testing.assert_allclose(float(tt), float(jt), rtol=VAL_RTOL)
        np.testing.assert_allclose(float(taux["mu"]), float(jaux["mu"]), rtol=VAL_RTOL)
        assert _norm_err(tg, jg) <= GRAD_TOL, step
        # the relaxed step's sums: K2-bf16's own forward (f32 weights)
        np.testing.assert_allclose(tst[0].numpy(), np.asarray(jst[0]), rtol=VAL_RTOL)
        assert tst[2] == int(jst[2]) == step + 1
        jparams = jax.tree.map(lambda p, d: p - 3e-3 * d, jparams, jg)
        tparams = params_from_numpy([(np.asarray(w), np.asarray(b))
                                     for w, b in jparams], device="cpu")


@pytest.mark.parametrize("delayed", [False, True])
def test_bf16_run_mode_matches_jax_n_runs_2(delayed):
    """runs=True (and the single-run vag's run_axis twin) against JAX's
    lane-packed n_runs = 2, per-run γ, scale and bases."""
    layers = (1, 32, 32, 1)
    kw = dict(n_points=256, lb=-8.0, ub=8.0, potential="harmonic", basis="hermite",
              p=3.0, nonlinearity="power", activation="shifted_tanh",
              use_perturbation=True, layers=layers)
    jspec, tspec = jprob.GPESpec(**kw), tprob.GPESpec(**kw)
    batch = {k: np.asarray(v) for k, v in jprob.make_batch(jspec, 0).items()}
    b1 = jprob.make_batch(jspec, 1)
    bases = {k: np.stack([batch[k], np.asarray(b1[k])])
             for k in ("base_val", "base_lap", "base_bval")}
    rng = np.random.default_rng(4)
    runs = [(rng.normal(0.0, 1.0 / np.sqrt(k), (2, k, m)).astype(np.float32),
             rng.normal(0.0, 0.1, (2, m)).astype(np.float32))
            for k, m in zip(layers[:-1], layers[1:])]
    gammas, scales = np.float32([0.5, 2.0]), np.float32([0.01, 0.02])
    modes = dict(delayed=True, fresh_values=True, extrapolate=True) if delayed else {}
    pvag = _jvag(jspec, 128, n_runs=2, **modes)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb.update({k: jnp.asarray(v.T) for k, v in bases.items()})
    p_u = jax.tree.map(lambda a: a[0], jpack.pack_params(
        tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in runs), 2))
    jargs = (p_u, jb, jnp.asarray(gammas), jnp.asarray(scales))
    tb = {k: torch.as_tensor(v) for k, v in {**batch, **bases}.items()}
    targs = (params_from_numpy(runs, device="cpu"), tb, torch.as_tensor(gammas),
             torch.as_tensor(scales))
    for tvag in (_tvag(tspec, runs=True, **modes), _tvag(tspec, **modes).run_axis):
        if delayed:
            jst, tst = pvag.init_state(*jargs), tvag.init_state(*targs)
            (jt, jaux), jg, _ = pvag(*jargs, jst)
            (tt, taux), tg, _ = tvag(*targs, tst)
        else:
            (jt, jaux), jg = pvag(*jargs)
            (tt, taux), tg = tvag(*targs)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=VAL_RTOL)
        np.testing.assert_allclose(taux["mu"].numpy(), np.asarray(jaux["mu"]),
                                   rtol=VAL_RTOL)
        jg_runs = jpack.unpack_params(jax.tree.map(lambda a: a[None], jg), layers, 2)
        for r in range(2):
            assert _norm_err([(w[r], b[r]) for w, b in tg],
                             [(np.asarray(w)[r], np.asarray(b)[r]) for w, b in jg_runs]
                             ) <= GRAD_TOL, r


def test_fit_with_the_bf16_vag_matches_jax_fit():
    """fit(value_and_grad_fn=) with the bf16 vag, 4 epochs on both sides."""
    jspec, tspec, jparams, tparams, jbatch, tbatch, gamma, scale, tile = \
        _setup("2d_vanilla_tanh")
    jr = jloop.fit(jprob.make_loss_fn(jspec), jpl.ramp_optimizer(1e-3), jparams, jbatch,
                   jnp.float32(gamma), jnp.float32(scale), epochs=4, check_every=2,
                   value_and_grad_fn=_jvag(jspec, tile))
    tr = tloop.fit(tprob.make_loss_fn(tspec), tpl.ramp_optimizer(1e-3), tparams, tbatch,
                   gamma, scale, epochs=4, check_every=2, value_and_grad_fn=_tvag(tspec))
    np.testing.assert_allclose(tr.loss_history, np.asarray(jr.loss_history),
                               rtol=VAL_RTOL)
    assert _norm_err(tr.final_params, jr.final_params) <= GRAD_TOL


def test_bf16_cpu_calls_take_the_plain_version_and_count_no_launch():
    _, tspec, _, tparams, _, tbatch, gamma, scale, _ = _setup("2d_perturbation")
    for fn in (k2.collocation_grads, k2.collocation_grads_runs, k1.collocation_sums_runs):
        fn.launches = fn.bf16_launches = 0
    args = (tparams, tbatch["x"], tbatch["V"], tbatch["w"], gamma, scale)
    base = (tbatch["base_val"], tbatch["base_lap"])
    phys = (tspec.activation, tspec.p, tspec.kinetic, tspec.nonlinearity)
    cots = torch.tensor([1e-3, -2e-3, 1e-3, 0.5])
    got, sums = k2.collocation_grads(*args, cots, *base, *phys, compute_dtype=BF16)
    want, wsums = k2.collocation_grads_bf16_plain(*args, cots, *base, *phys)
    assert torch.equal(sums, wsums)
    assert all(torch.equal(a, b) for (a, _), (b, _) in zip(got, want))
    stacked = tuple((torch.stack([w, w]), torch.stack([b, b])) for w, b in tparams)
    rgot, rsums = k2.collocation_grads_runs(stacked, *args[1:], torch.stack([cots, cots]),
                                            *base, *phys, compute_dtype=BF16)
    assert torch.equal(rsums[1], sums) and torch.equal(rgot[0][0][1], got[0][0])
    ssums = k1.collocation_sums_runs(stacked, *args[1:], *base, *phys,
                                     compute_dtype=BF16)
    assert torch.equal(ssums[0], k1.collocation_sums(*args, *base, *phys,
                                                     compute_dtype=BF16))
    for fn in (k2.collocation_grads, k2.collocation_grads_runs, k1.collocation_sums_runs):
        assert fn.launches == fn.bf16_launches == 0
    with pytest.raises(ValueError, match="compute_dtype"):
        k2.make_value_and_grad(tspec.layers, compute_dtype=torch.float16)
