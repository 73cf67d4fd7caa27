"""K2's psum-aware mode and `fit(mesh=)` on two gloo ranks on the CPU,
against JAX's unsharded gradient and the port's unsharded paths (the
contracts of tests/test_fused_sharded.py and test_parallel.py's fit tests).

The ranks run in child processes (`experiments/mesh_check.run_cases`, one
spawn for the module) that import no JAX; JAX runs here, in the parent,
unsharded, with K2 in interpret mode as tests/test_fused_sharded.py runs
it. Inputs come from numpy with a seed; on the CPU every kernel wrapper
takes its plain version. Tolerances: against JAX's XLA gradient total and
μ rtol 1e-5, gradients normalised 2e-4; against the port's unsharded vag
on the same plain version total rtol 1e-6, gradients normalised 1e-5,
the relaxed state rtol 1e-5; fits rtol 1e-4 (best loss, μ, histories).
Results that are replicated must be bit-equal across the ranks.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.pallas.fused_grad import make_pallas_value_and_grad  # noqa: E402
from gpe_tpu.train import loop as jloop  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu.train.optimizers import make_optimizer as jmake_optimizer  # noqa: E402
from gpe_tpu_torch.experiments.mesh_check import flat, run_cases, walk  # noqa: E402
from gpe_tpu_torch.kernels import fused_grad as k2  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import loop as tloop  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402
from gpe_tpu_torch.train.optimizers import make_optimizer  # noqa: E402

VAG = dict(n_points=512, dim=1, layers=(1, 16, 16, 1), activation="tanh")
FIT = dict(lb=-6.0, ub=6.0, n_points=512, layers=(1, 12, 12, 1), potential="harmonic",
           basis="hermite", nonlinearity="abs_power", use_perturbation=True)


def _np_params(layers, seed):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1.0, 1.0, (k, m)).astype(np.float32)
             * np.float32(np.sqrt(6.0 / (k + m))), np.full((m,), 0.01, np.float32))
            for k, m in zip(layers[:-1], layers[1:])]


def _specs(kw):
    return jprob.GPESpec(**kw), tprob.GPESpec(**kw)


def _port_vag(spec, delayed=False, **kw):
    return k2.make_value_and_grad(spec.layers, spec.activation, spec.p, spec.kinetic,
                                  spec.nonlinearity, bc_weight=spec.bc_weight,
                                  norm_weight=spec.norm_weight, delayed=delayed, **kw)


def _jax_vag(spec, **kw):
    return make_pallas_value_and_grad(
        spec.layers, spec.activation, spec.p, spec.kinetic, spec.nonlinearity,
        bc_weight=spec.bc_weight, norm_weight=spec.norm_weight,
        tile=64, sum_tile=64, interpret=True, **kw)


def _assert_grads_close(got, want, atol):
    """Per leaf of the flat gradients (the layout of `mesh_check.flat`):
    max |Δ| / max |want| ≤ atol."""
    sizes = [a.size for W, b in _np_params(VAG["layers"], 0) for a in (W, b)]
    for g, w in zip(np.split(got, np.cumsum(sizes)[:-1]),
                    np.split(want, np.cumsum(sizes)[:-1])):
        sc = np.max(np.abs(w)) + 1e-12
        np.testing.assert_allclose(g / sc, w / sc, atol=atol)


PERT = dict(VAG, use_perturbation=True)
VANILLA = dict(VAG, use_perturbation=False)
CASES = [
    ("xla", "vag", dict(spec=tprob.GPESpec(**PERT), params=_np_params(VAG["layers"], 0),
                        gamma=2.0, scale=0.05)),
    ("same", "vag", dict(spec=tprob.GPESpec(**VANILLA),
                         params=_np_params(VAG["layers"], 1), gamma=1.0, scale=0.01)),
    ("relaxed", "vag", dict(spec=tprob.GPESpec(**PERT), params=_np_params(VAG["layers"], 2),
                            gamma=3.0, scale=0.05, relaxed=True, steps=2)),
    ("corrector", "vag", dict(spec=tprob.GPESpec(**PERT),
                              params=_np_params(VAG["layers"], 5), gamma=3.0, scale=0.05,
                              relaxed=None, steps=4, refresh_every=2, exact_until=2)),
    ("bf16", "vag", dict(spec=tprob.GPESpec(**PERT), params=_np_params(VAG["layers"], 6),
                         gamma=3.0, scale=0.05, relaxed=None, steps=3, refresh_every=2,
                         bf16=True)),
    ("fused_fit", "fit", dict(spec=tprob.GPESpec(**PERT), params=_np_params(VAG["layers"], 3),
                              gamma=1.0, scale=0.05, epochs=60, check_every=30,
                              fused=True, relaxed=False, clip_norm=None)),
    ("plain_fit", "fit", dict(spec=tprob.GPESpec(**FIT), params=_np_params(FIT["layers"], 4),
                              gamma=1.0, scale=0.01, epochs=150, check_every=64,
                              fused=False)),
]


@pytest.fixture(scope="module")
def ranks():
    """Every case on two gloo ranks, once for the module."""
    return run_cases(CASES, nprocs=2, backend="gloo", device="cpu")


def _bit_equal(ranks, label, keys):
    for k in keys:
        np.testing.assert_array_equal(ranks[0][f"{label}/{k}"], ranks[1][f"{label}/{k}"],
                                      err_msg=k)


def test_sharded_fused_vag_matches_jax_xla_gradient(ranks):
    """The perturbation ansatz with its base streams sharded with the
    points, against jax.value_and_grad of JAX's plain loss, unsharded."""
    jspec, _ = _specs(PERT)
    jb = jprob.make_batch(jspec, 0)
    p = [(jnp.asarray(W), jnp.asarray(b)) for W, b in _np_params(VAG["layers"], 0)]
    (total, aux), grads = jax.value_and_grad(jprob.make_loss_fn(jspec), has_aux=True)(
        p, jb, jnp.float32(2.0), jnp.float32(0.05))
    r = ranks[0]
    np.testing.assert_allclose(r["xla/total"][0], float(total), rtol=1e-5)
    np.testing.assert_allclose(r["xla/mu"][0], float(aux["mu"]), rtol=1e-5)
    want = np.concatenate([np.asarray(a, np.float64).ravel() for W, b in grads
                           for a in (W, b)])
    _assert_grads_close(r["xla/grads"][0], want, atol=2e-4)
    _bit_equal(ranks, "xla", ("total", "mu", "grads"))


def test_sharded_fused_vag_matches_unsharded_port_vag(ranks):
    """The vanilla ansatz, sharded against unsharded on the same plain
    version: the same float operations up to the order of the sums."""
    _, tspec = _specs(VANILLA)
    tb = tprob.make_batch(tspec, 0, device="cpu")
    p = params_from_numpy(_np_params(VAG["layers"], 1), device="cpu")
    (total, _), grads = _port_vag(tspec)(p, tb, 1.0, 0.01)
    r = ranks[0]
    np.testing.assert_allclose(r["same/total"][0], float(total), rtol=1e-6)
    _assert_grads_close(r["same/grads"][0], flat(grads), atol=1e-5)
    _bit_equal(ranks, "same", ("total", "mu", "grads"))


def test_sharded_bf16_vag_matches_unsharded_bf16_vag(ranks):
    """K2's bf16 operand mode under `group=` (the default relaxed step with
    a K1-bf16 refresh at step 2, three steps): the global sums and the
    gradients of the unsharded bf16 vag (total rtol 1e-6, state 1e-5;
    gradients normalised 2e-4, the bf16 mode's bound: a shard's products
    may round a state value near a bf16 boundary the other way, 3.3e-5
    here); the same state on both ranks."""
    _, tspec = _specs(PERT)
    tb = tprob.make_batch(tspec, 0, device="cpu")
    p = params_from_numpy(_np_params(VAG["layers"], 6), device="cpu")
    vag = _port_vag(tspec, delayed=True, fresh_values=True, extrapolate=True,
                    refresh_every=2, compute_dtype=torch.bfloat16)
    want = walk(vag, p, tb, 3.0, 0.05, steps=3)
    r = ranks[0]
    np.testing.assert_allclose(r["bf16/total"], want["total"], rtol=1e-6)
    np.testing.assert_allclose(r["bf16/state"], want["state"], rtol=1e-5)
    for got, w in zip(r["bf16/grads"], want["grads"]):
        _assert_grads_close(got, w, atol=2e-4)
    _bit_equal(ranks, "bf16", ("total", "mu", "grads", "state"))


def test_sharded_relaxed_state_matches_unsharded_over_two_steps(ranks):
    """The relaxed form: the state holds the global sums after init_state
    and after each of two steps (params walked downhill between them),
    against the port's unsharded relaxed vag and JAX's interpret-mode one;
    the same state on both ranks."""
    jspec, tspec = _specs(PERT)
    tb = tprob.make_batch(tspec, 0, device="cpu")
    np_p = _np_params(VAG["layers"], 2)
    p = params_from_numpy(np_p, device="cpu")
    vag = _port_vag(tspec, delayed=True)
    jb = jprob.make_batch(jspec, 0)
    jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in np_p]
    jvag = _jax_vag(jspec, delayed=True)
    g, s = 3.0, 0.05
    want = walk(vag, p, tb, g, s, steps=2)
    jst = jvag.init_state(jp, jb, jnp.float32(g), jnp.float32(s))
    jstates = [np.asarray(jst[0])]
    for _ in range(2):
        (_, _), jgr, jst = jvag(jp, jb, jnp.float32(g), jnp.float32(s), jst)
        jstates.append(np.asarray(jst[0]))
        jp = [(w - 1e-3 * gw, b - 1e-3 * gb) for (w, b), (gw, gb) in zip(jp, jgr)]
    r = ranks[0]
    np.testing.assert_allclose(r["relaxed/state"], want["state"], rtol=1e-5)
    np.testing.assert_allclose(r["relaxed/state"], np.asarray(jstates), rtol=1e-5)
    np.testing.assert_allclose(r["relaxed/total"], want["total"], rtol=1e-6)
    for got, w in zip(r["relaxed/grads"], want["grads"]):
        _assert_grads_close(got, w, atol=1e-5)
    _bit_equal(ranks, "relaxed", ("state", "total", "grads"))


def test_sharded_relaxed_correctors_match_unsharded_over_four_steps(ranks):
    """The default relaxed form (fresh values, extrapolation) with its exact
    K1 correctors, exact_until=2 and refresh_every=2: step 1 and step 2
    take the corrector (its sums reduced over the ranks), steps 0 and 3 do
    not. Four steps against the port's unsharded vag of the same settings,
    at the same-kernel bounds; the same on both ranks."""
    _, tspec = _specs(PERT)
    vag = _port_vag(tspec, delayed=True, fresh_values=True, extrapolate=True,
                    refresh_every=2, exact_until=2)
    want = walk(vag, params_from_numpy(_np_params(VAG["layers"], 5), device="cpu"),
                tprob.make_batch(tspec, 0, device="cpu"), 3.0, 0.05, steps=4)
    r = ranks[0]
    assert np.isfinite(r["corrector/total"]).all() and np.isfinite(want["total"]).all()
    np.testing.assert_allclose(r["corrector/state"], want["state"], rtol=1e-5)
    np.testing.assert_allclose(r["corrector/total"], want["total"], rtol=1e-6)
    np.testing.assert_allclose(r["corrector/mu"], want["mu"], rtol=1e-6)
    for got, w in zip(r["corrector/grads"], want["grads"]):
        _assert_grads_close(got, w, atol=1e-5)
    _bit_equal(ranks, "corrector", ("state", "total", "grads"))


def test_fit_mesh_with_fused_vag_matches_unsharded_fused_fit(ranks):
    """fit(mesh=, value_and_grad_fn=) with the exact fused vag, 60 steps of
    Adam: the loss falls and matches the unsharded fused fit; every rank
    records the same history."""
    _, tspec = _specs(PERT)
    ref = tloop.fit(tprob.make_loss_fn(tspec), make_optimizer("adam", 1e-3),
                    params_from_numpy(_np_params(VAG["layers"], 3), device="cpu"),
                    tprob.make_batch(tspec, 0, device="cpu"), 1.0, 0.05, epochs=60,
                    tol=0.0, patience=10 ** 9, check_every=30,
                    value_and_grad_fn=_port_vag(tspec))
    r = ranks[0]
    assert np.isfinite(r["fused_fit/best_loss"])
    assert r["fused_fit/best_loss"] < r["fused_fit/loss_history"][0]
    np.testing.assert_allclose(r["fused_fit/best_loss"], ref.best_loss, rtol=1e-4)
    np.testing.assert_allclose(r["fused_fit/mu_best"], ref.mu_best, rtol=1e-4)
    _bit_equal(ranks, "fused_fit", ("loss_history", "mu_history", "params", "best_loss"))


def test_fit_mesh_plain_loss_matches_single_process_fit(ranks):
    """fit(mesh=) on the sharded plain loss (autograd, the gradients
    averaged over the ranks), 150 steps of Adam with clip 1.0: loss and μ
    histories against the port's single-process fit and JAX's; the
    histories bit-equal across the ranks."""
    jspec, tspec = _specs(FIT)
    np_p = _np_params(FIT["layers"], 4)
    kw = dict(epochs=150, tol=-1.0, patience=10 ** 9, check_every=64)
    ref = tloop.fit(tprob.make_loss_fn(tspec), make_optimizer("adam", 1e-3, clip_norm=1.0),
                    params_from_numpy(np_p, device="cpu"),
                    tprob.make_batch(tspec, 0, device="cpu"), 1.0, 0.01, **kw)
    jref = jloop.fit(jprob.make_loss_fn(jspec), jmake_optimizer("adam", 1e-3, clip_norm=1.0),
                     [(jnp.asarray(W), jnp.asarray(b)) for W, b in np_p],
                     jprob.make_batch(jspec, 0), 1.0, 0.01, **kw)
    r = ranks[0]
    for want in (ref, jref):
        np.testing.assert_allclose(r["plain_fit/loss_history"], want.loss_history,
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(r["plain_fit/mu_history"], want.mu_history, rtol=1e-4)
        np.testing.assert_allclose(r["plain_fit/mu_best"], want.mu_best, rtol=1e-4)
    np.testing.assert_allclose(r["plain_fit/params"], flat(ref.params), rtol=2e-4,
                               atol=1e-6)
    _bit_equal(ranks, "plain_fit", ("loss_history", "mu_history", "params", "best_loss"))


def test_fused_vags_are_psum_aware_and_the_fits_ran_alike(ranks):
    """Every form of the fused vag carries psum_aware; on the CPU no kernel
    launches (the plain versions run), on both ranks alike."""
    _, tspec = _specs(PERT)
    for delayed in (False, True):
        vag = _port_vag(tspec, delayed)
        assert vag.psum_aware and vag.run_axis.psum_aware
    for rank in ranks:
        assert int(rank["fused_fit/launches_fused_grad"]) == 0
        assert int(rank["fused_fit/epochs_run"]) == 60
