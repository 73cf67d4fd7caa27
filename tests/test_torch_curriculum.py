"""Port parity of the curriculum trainer (`gpe_tpu_torch/train/curriculum.py`)
and `fit(scale_schedule=)` against the JAX package on the CPU (f32, small
sizes).

`fit` with the α schedule from carried params and JAX's batch, 30 steps
at LR 1e-4: loss history and μ at rtol 1e-5 (at LR 1e-3 the first steps'
loss swings by 4× and f32 rounding grows past 1e-5 within 30 steps).
The two-η `train_curriculum` runs from JAX's own per-η initial nets
(handed out by a monkeypatched `init_mlp`), η = 0 stopping early on
patience so the frozen stack is folded with α at `epochs_run`: epochs
equal, loss histories at rtol 1e-4 (the second η trains on the first's
folded base, so the first's rounding carries over), μ at rtol 1e-5.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.train import curriculum as jcur  # noqa: E402
from gpe_tpu.train import loop as jloop  # noqa: E402
from gpe_tpu.train import optimizers as jopt  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.models import mlp as tmlp  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import curriculum as tcur  # noqa: E402
from gpe_tpu_torch.train import loop as tloop  # noqa: E402
from gpe_tpu_torch.train import optimizers as topt  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

SPEC = dict(lb=-10.0, ub=10.0, n_points=256, layers=(1, 16, 16, 1), activation="tanh",
            use_perturbation=True)


def _np(params):
    return jax.tree.map(np.asarray, params)


def test_alpha_schedule_matches_jax():
    j, t = jcur.alpha_schedule(1.0, 1e-3), tcur.alpha_schedule(1.0, 1e-3)
    for epoch in (0, 1, 7, 100, 999, 2302, 2303, 5000):
        assert isinstance(t(epoch), np.float32)
        np.testing.assert_allclose(t(epoch), float(j(jnp.asarray(epoch))), rtol=1e-7)
    assert t(0) == 1.0 and t(10**6) == np.float32(1.9)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_fit_with_scale_schedule_matches_jax(name):
    """30 steps of fit under the α schedule (decay 0.05, so α moves over
    the run) from carried params and JAX's batch (its base arrays in it)."""
    jspec, tspec = jprob.GPESpec(**SPEC), tprob.GPESpec(**SPEC)
    p0 = _np(jmlp.init_mlp(jax.random.PRNGKey(3), SPEC["layers"]))
    jbatch = jprob.make_batch(jspec, 0)
    tbatch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    jres = jloop.fit(jprob.make_loss_fn(jspec), jopt.make_optimizer(name, 1e-4, clip_norm=1.0),
                     jax.tree.map(jnp.asarray, p0), jbatch, 2.0, 1.0,
                     epochs=30, tol=0.0, patience=10**9, check_every=10,
                     scale_schedule=jcur.alpha_schedule(1.0, 0.05))
    tres = tloop.fit(tprob.make_loss_fn(tspec), topt.make_optimizer(name, 1e-4, clip_norm=1.0),
                     params_from_numpy(p0, device="cpu"), tbatch, 2.0, 1.0, epochs=30,
                     tol=0.0, patience=10**9, check_every=10,
                     scale_schedule=tcur.alpha_schedule(1.0, 0.05))
    assert tres.epochs_run == jres.epochs_run == 30
    np.testing.assert_allclose(tres.loss_history, jres.loss_history, rtol=1e-5)
    np.testing.assert_allclose(tres.mu_history, jres.mu_history, rtol=1e-5)
    np.testing.assert_allclose(tres.mu_best, jres.mu_best, rtol=1e-5)


def test_train_curriculum_matches_jax(monkeypatch):
    """Two η from JAX's per-η nets; η = 0 early-stops on patience 5."""
    spec_j, spec_t = jprob.GPESpec(**SPEC), tprob.GPESpec(**SPEC)
    kw = dict(epochs=30, check_every=10, patience=5, seed=0)
    jres = jcur.train_curriculum(spec_j, [0.0, 10.0], **kw)
    key = jax.random.PRNGKey(0)
    nets = [_np(jmlp.init_mlp(key, SPEC["layers"], "xavier_uniform"))]
    key, sub = jax.random.split(key)
    nets.append(_np(jmlp.init_mlp(sub, SPEC["layers"], "xavier_uniform")))
    handed = list(nets)

    def jax_nets(layers, scheme, generator=None, dtype=None, device=None, **_):
        return params_from_numpy(handed.pop(0), device=device, dtype=dtype)

    monkeypatch.setattr(tcur.mlp, "init_mlp", jax_nets)
    tres = tcur.train_curriculum(spec_t, [0.0, 10.0], device="cpu", **kw)
    assert not handed
    assert tres.epochs_by_eta == jres.epochs_by_eta and jres.epochs_by_eta[0.0] < 30
    for eta in (0.0, 10.0):
        np.testing.assert_allclose(tres.history_by_eta[eta]["loss"],
                                   jres.history_by_eta[eta]["loss"], rtol=1e-4)
    np.testing.assert_allclose([m for _, m in tres.mu_table],
                               [m for _, m in jres.mu_table], rtol=1e-5)
    assert [e for e, _ in tres.mu_table] == [0.0, 10.0]
    for eta in (0.0, 10.0):
        for (tw, tb), (jw, jb) in zip(tres.params_by_eta[eta], jres.params_by_eta[eta]):
            np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)


def test_train_curriculum_draws_one_fresh_net_per_eta():
    """Fresh nets from one generator seeded by `seed`, one draw per η (the
    first η's net is the generator's first draw); the base must be on."""
    spec = tprob.GPESpec(**SPEC)
    res = tcur.train_curriculum(spec, [0.0, 10.0], epochs=1, check_every=1, lr=0.0,
                                device="cpu")
    g = torch.Generator().manual_seed(0)
    for eta in (0.0, 10.0):
        want = tmlp.init_mlp(SPEC["layers"], generator=g, device="cpu")
        for (w, b), (tw, tb) in zip(res.params_by_eta[eta], want):
            np.testing.assert_array_equal(w, tw.numpy())
    with pytest.raises(ValueError, match="use_perturbation"):
        tcur.train_curriculum(tprob.GPESpec(**{**SPEC, "use_perturbation": False}), [0.0],
                              device="cpu")
