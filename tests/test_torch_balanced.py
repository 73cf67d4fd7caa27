"""Port parity of ReLoBRaLo balancing (`losses/balancing.py:relobralo_step`,
`train/balanced.py:fit_relobralo`) and the runner's `relobralo` branch,
against the JAX package on the CPU at small sizes.

The port draws the Bernoulli(ρ) lookback from a torch.Generator, JAX from a
jax.random key, so their bits cannot match. At ρ = 1 and ρ = 0 the draw is
deterministic on both sides (uniform < 1 always, uniform < 0 never), and
there the λ trajectories of the step agree to 1e-6 (f32, the same
arithmetic). At ρ = 0.999 the lookback rate is held by statistics: the
count of lookbacks in 50,000 steps within 5σ of the expected 50.
`fit_relobralo` at ρ = 1 from the same params: loss and λ histories rtol
1e-4, μ histories rtol 1e-5 (the fit-parity bounds of test_torch_train.py).
"""
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.losses import balancing as jbal  # noqa: E402
from gpe_tpu.train import balanced as jbalanced  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.experiments import run  # noqa: E402
from gpe_tpu_torch.experiments.configs import EXPERIMENTS  # noqa: E402
from gpe_tpu_torch.losses import balancing as tbal  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import balanced as tbalanced  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

# the keys of the JAX runner's relobralo record (gpe_tpu/experiments/run.py:309-311)
JAX_RECORD = {"gamma", "mu", "loss", "lambdas"}


def _loss_sequence(steps=40, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 10.0, (steps, n)) * np.exp(-0.05 * np.arange(steps))[:, None]
            ).astype(np.float32)


@pytest.mark.parametrize("rho", [0.0, 1.0])
@pytest.mark.parametrize("alpha", [0.999, 0.5])
def test_relobralo_step_matches_jax_where_the_draw_is_deterministic(rho, alpha):
    seq = _loss_sequence()
    jstate, key = jbal.relobralo_init(seq.shape[1]), jax.random.PRNGKey(3)
    tstate = tbal.relobralo_init(seq.shape[1], device="cpu")
    gen = torch.Generator().manual_seed(3)
    jl, tl = [], []
    for losses in seq:
        key, sub = jax.random.split(key)
        lam, jstate = jbal.relobralo_step(jstate, jnp.asarray(losses), sub,
                                          alpha=alpha, temperature=0.1, rho=rho)
        jl.append(np.asarray(lam))
        lam_t, tstate = tbal.relobralo_step(tstate, torch.as_tensor(losses), gen,
                                            alpha=alpha, temperature=0.1, rho=rho)
        tl.append(lam_t.numpy())
    np.testing.assert_allclose(np.array(tl), np.array(jl), rtol=1e-6, atol=1e-6)
    assert int(tstate.step) == int(jstate.step) == len(seq)
    np.testing.assert_array_equal(tstate.init_losses.numpy(), seq[0])
    np.testing.assert_array_equal(tstate.last_losses.numpy(), seq[-1])
    np.testing.assert_array_equal(tl[0], np.ones(seq.shape[1], np.float32))


def test_relobralo_lookback_rate_at_rho_0999():
    """α = 1 leaves λ' = ρλ + (1−ρ)·λ_lookback, so each step shows which of
    λ_hat and λ_init it drew: the lookback (λ_init) in 1 − ρ of the steps."""
    rho, steps = 0.999, 50_000
    losses = [torch.tensor([1.0, 2.0, 4.0]), torch.tensor([2.0, 1.0, 0.5])]
    state = tbal.relobralo_init(3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    lam, state = tbal.relobralo_step(state, losses[0], gen, alpha=1.0, rho=rho)
    n = 3

    def bal(ref):
        z = losses[1] / (0.1 * (ref + 1e-12))
        return n * torch.softmax(z - torch.max(z), dim=0)

    lam_hat, lam_init = bal(losses[1]), bal(losses[0])
    lookbacks = 0
    for _ in range(steps):
        prev = lam
        # the same losses each step: λ_hat and λ_init stay fixed
        state = state._replace(last_losses=losses[1])
        lam, state = tbal.relobralo_step(state, losses[1], gen, alpha=1.0, rho=rho)
        d_hat = float(torch.max(torch.abs(lam - (rho * prev + (1 - rho) * lam_hat))))
        d_init = float(torch.max(torch.abs(lam - (rho * prev + (1 - rho) * lam_init))))
        assert min(d_hat, d_init) < 1e-6
        lookbacks += d_init < d_hat
    expected = (1 - rho) * steps
    sigma = np.sqrt(steps * rho * (1 - rho))
    assert abs(lookbacks - expected) <= 5 * sigma, lookbacks


SPEC = dict(dim=2, lb=-6.0, ub=6.0, n_points=9, layers=(2, 12, 12, 1),
            activation="tanh", potential="harmonic", potential_kwargs=(("a", 0.5),),
            kinetic=0.5, nonlinearity="abs_power", use_perturbation=False,
            symmetry="y_even", sym_weight=500.0, riesz_weight=1.0,
            bc_weight=500.0, norm_weight=100.0, pde_weight=2.0)


def test_fit_relobralo_matches_jax_at_rho_1():
    """A 2D y-even symmetry spec like gpe2d_relobralo's (Riesz and symmetry
    terms, the manual weights 500/100/2), 25 steps from the same params."""
    jspec, tspec = jprob.GPESpec(**SPEC), tprob.GPESpec(**SPEC)
    jparams = jprob.init_params(jspec, jax.random.PRNGKey(0))
    jbatch = jprob.make_batch(jspec, 0)
    jres = jbalanced.fit_relobralo(jspec, jparams, jbatch, 10.0, epochs=25, lr=1e-3,
                                   rho=1.0)
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
    tparams = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jparams],
                                device="cpu")
    tres = tbalanced.fit_relobralo(tspec, tparams, tbatch, 10.0, epochs=25, lr=1e-3,
                                   rho=1.0)
    assert tres.term_names == jres.term_names == ("boundary", "norm", "pde", "riesz",
                                                  "sym")
    np.testing.assert_allclose(tres.loss_history, jres.loss_history, rtol=1e-4)
    np.testing.assert_allclose(tres.lambda_history, jres.lambda_history, rtol=1e-4)
    np.testing.assert_allclose(tres.mu_history, jres.mu_history, rtol=1e-5)
    assert tres.mu == pytest.approx(jres.mu, rel=1e-5)
    assert tres.best_loss == pytest.approx(jres.best_loss, rel=1e-4)
    assert tres.best_loss == float(np.min(tres.loss_history))
    for (tw, tb), (jw, jb) in zip(tres.params, jres.params):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


def test_run_main_relobralo_branch_warm_starts_across_gammas(tmp_path, monkeypatch,
                                                             capsys):
    """gpe2d_relobralo at 9² points and [2,12,12,1], two γ of 8 epochs: the
    JAX record's keys per γ (plus `seconds`), and the second γ's fit starts
    from the first's last params (the records equal two chained calls)."""
    cfg = EXPERIMENTS["gpe2d_relobralo"]
    small = replace(cfg, spec=replace(cfg.spec, n_points=9, layers=(2, 12, 12, 1)))
    monkeypatch.setitem(EXPERIMENTS, "gpe2d_relobralo", small)
    assert run.main(["gpe2d_relobralo", "--cpu", "--epochs", "8", "--gammas", "10",
                     "12", "--out", str(tmp_path)]) == 0
    recs = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()
            if s.startswith("{")]
    assert [r["gamma"] for r in recs] == [10.0, 12.0]
    for r in recs:
        assert set(r) == JAX_RECORD | {"seconds"}
        assert set(r["lambdas"]) == {"boundary", "norm", "pde", "riesz", "sym"}
    spec = small.spec
    batch = tprob.make_batch(spec, 0, device="cpu")
    params = tprob.init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    for r, g in zip(recs, (10.0, 12.0)):
        res = tbalanced.fit_relobralo(spec, params, batch, g, epochs=8, lr=small.lr)
        params = res.params
        assert (r["mu"], r["loss"]) == (res.mu, res.best_loss)
    assert json.loads((tmp_path / "gpe2d_relobralo" / "summary.json").read_text()) == recs
