"""Port parity of the deflation trainer (`train/deflation.py`:
`make_deflated_loss_fn`, `_make_polish`, `train_deflation`) and the
runner's `deflation` branch, against the JAX package on the CPU at small
sizes.

Tolerances: the deflated loss in f64 with no, and with two, frozen states:
values rtol 1e-6 / atol 1e-7 and gradients normalised atol 1e-5 (the
bounds of test_torch_train.py; the JAX package reduces the loss sums in
f32 even under x64). `train_deflation` from the JAX package's
mode-scaled inits, carried over by monkeypatching: the loss histories
rtol 1e-4 and μ histories rtol 1e-5 (the fit-parity bounds), the states
within 1e-4, the μ table within 1e-5 relative, with and without a short
f32 LM polish; the polish alone in f64 at test_torch_run.py's f64 LM
bounds (1e-6).
The deflated states of a longer run are orthonormal on the quadrature
grid to 5e-2, the bound of tests/test_deflation.py.
"""
import json
import math
from dataclasses import replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.train import deflation as jdefl  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.experiments import run  # noqa: E402
from gpe_tpu_torch.experiments.configs import EXPERIMENTS  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import deflation as tdefl  # noqa: E402
from gpe_tpu_torch.train import loop as tloop  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

SPEC = dict(lb=-8.0, ub=8.0, n_points=128, layers=(1, 16, 16, 1), potential="harmonic",
            kinetic=1.0, nonlinearity="abs_power", activation="tanh", bc_weight=10.0,
            norm_weight=20.0, objective="riesz", use_perturbation=False)


def _np(params):
    return [(np.asarray(w), np.asarray(b)) for w, b in params]


@pytest.mark.parametrize("K", [0, 2])
def test_deflated_loss_and_grads_match_jax_f64(K):
    rng = np.random.default_rng(K)
    gamma, scale, weight = 4.0, 1.0, 500.0
    with jax.enable_x64(True):
        jspec = jprob.GPESpec(**SPEC, dtype=jnp.float64)
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                               jmlp.init_mlp(jax.random.PRNGKey(1), jspec.layers))
        jbatch = dict(jprob.make_batch(jspec, 0))
        states = rng.standard_normal((K, jbatch["x"].shape[0]))
        jbatch["orth_states"] = jnp.asarray(states)
        (jt, jaux), jg = jax.value_and_grad(jdefl.make_deflated_loss_fn(jspec, weight),
                                            has_aux=True)(jparams, jbatch, gamma, scale)
        jt, jaux = float(jt), {k: float(v) for k, v in jaux.items()}
        jg, np_params = _np(jg), _np(jparams)
    tspec = tprob.GPESpec(**SPEC, dtype=torch.float64)
    tbatch = dict(tprob.make_batch(tspec, 0, device="cpu"))
    tbatch["orth_states"] = torch.as_tensor(states)
    (tt, taux), tg = tloop.value_and_grad(tdefl.make_deflated_loss_fn(tspec, weight))(
        params_from_numpy(np_params, device="cpu", dtype=torch.float64), tbatch, gamma,
        scale)
    assert set(taux) == set(jaux) and ("orth" in taux) == (K > 0)
    np.testing.assert_allclose(float(tt), jt, rtol=1e-6)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(taux[k]), v, rtol=1e-6, atol=1e-7, err_msg=k)
    for (gw, gb), (ww, wb) in zip(tg, jg):
        for a, b in ((gw.numpy(), ww), (gb.numpy(), wb)):
            s = np.max(np.abs(b))
            np.testing.assert_allclose(a / s, b / s, atol=1e-5)
    if K == 0:                                      # no orth_states key at all
        del tbatch["orth_states"]
        t2, aux2 = tdefl.make_deflated_loss_fn(tspec, weight)(
            params_from_numpy(np_params, device="cpu", dtype=torch.float64), tbatch,
            gamma, scale)
        assert float(t2) == float(tt) and "orth" not in aux2


def _carry_inits(monkeypatch, layers, n_modes, seed=0):
    """The JAX package's mode-scaled init of each mode (key seed + 7·n),
    handed to the port's train_deflation in place of its own."""
    inits = {n: params_from_numpy(_np(jmlp.init_mlp(jax.random.PRNGKey(seed + 7 * n),
                                                    layers, "mode_scaled", mode=n)),
                                  device="cpu")
             for n in range(n_modes)}
    monkeypatch.setattr(tdefl.mlp, "init_mlp",
                        lambda layers, scheme, mode=0, **k: inits[mode])


@pytest.mark.parametrize("polish_steps", [0, 3])
def test_train_deflation_matches_jax_from_the_same_inits(polish_steps, monkeypatch):
    """Two modes of 20 epochs at γ = 5 (orth_weight 500), without and with a
    3-step LM polish (10 CG iterations) of each state in f32 (polished μ
    1.4e-6 apart; CG amplifies the f32 differences with the steps: 4.5e-5
    after 6, so the polish's own parity is held in f64 below)."""
    _carry_inits(monkeypatch, SPEC["layers"], 2)
    kw = dict(n_modes=2, epochs=20, lr=1e-3, orth_weight=500.0, check_every=10,
              polish_steps=polish_steps, polish_cg_iters=10)
    jres = jdefl.train_deflation(jprob.GPESpec(**SPEC), 5.0, **kw)
    tres = tdefl.train_deflation(tprob.GPESpec(**SPEC), 5.0, device="cpu", **kw)
    assert [n for n, _ in tres.mu_table] == [0, 1]
    for n in range(2):
        np.testing.assert_allclose(tres.history_by_mode[n]["loss"],
                                   np.asarray(jres.history_by_mode[n]["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tres.history_by_mode[n]["mu"],
                                   np.asarray(jres.history_by_mode[n]["mu"]), rtol=1e-5)
    np.testing.assert_allclose([m for _, m in tres.mu_table],
                               [m for _, m in jres.mu_table], rtol=1e-5)
    np.testing.assert_allclose(tres.states, jres.states, atol=1e-4)
    assert set(tres.seconds["lm"]) == (set() if polish_steps == 0 else {0, 1})


def test_polish_matches_jax_f64():
    """`_make_polish` from the same params on the same batch with two frozen
    states, in float64 on both sides: the same λ decisions, loss histories
    rtol 1e-6, params within 1e-6 (test_torch_run.py's f64 LM bounds: CG
    amplifies ~1e-15 differences of the matvecs), and the normalised μ of
    the polished params within 1e-6."""
    rng = np.random.default_rng(5)
    p = [(0.5 * rng.standard_normal((i, o)), 0.1 * rng.standard_normal(o))
         for i, o in zip(SPEC["layers"][:-1], SPEC["layers"][1:])]
    with jax.enable_x64(True):
        jspec = jprob.GPESpec(**SPEC, dtype=jnp.float64)
        jbatch = dict(jprob.make_batch(jspec, 0))
        jbatch["orth_states"] = jnp.asarray(rng.standard_normal((2, 128)))
        jp = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in p)
        jres = jdefl._make_polish(jspec, jp, 4, 15)(jp, jbatch, 5.0, 1.0)
        jmu = float(jdefl._normalized_mu(jspec, jres.params, jbatch, 5.0))
        jloss, jlam, jparams = (np.asarray(jres.loss_history),
                                np.asarray(jres.lam_history), _np(jres.params))
    tspec = tprob.GPESpec(**SPEC, dtype=torch.float64)
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in jbatch.items()}
    tp = params_from_numpy(p, device="cpu", dtype=torch.float64)
    tres = tdefl._make_polish(tspec, tp, 4, 15)(tp, tbatch, 5.0, 1.0)
    tmu = float(tdefl._normalized_mu(tspec, tres.params, tbatch, 5.0))
    np.testing.assert_array_equal(tres.lam_history, jlam)
    np.testing.assert_allclose(tres.loss_history, jloss, rtol=1e-6)
    for (tw, tb), (jw, jb) in zip(tres.params, jparams):
        np.testing.assert_allclose(tw.numpy(), jw, atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), jb, atol=1e-6)
    assert abs(tmu - jmu) <= 1e-6 * abs(jmu), (tmu, jmu)


def test_deflated_states_are_orthonormal():
    """Three modes of 600 epochs at γ = 0: the Gram matrix of the states on
    the grid within 5e-2 of the identity (measured 4.8e-3) and the ladder
    ascending."""
    res = tdefl.train_deflation(tprob.GPESpec(**SPEC), 0.0, n_modes=3, epochs=600,
                                lr=2e-3, orth_weight=500.0, device="cpu")
    S = res.states
    w = 16.0 / (SPEC["n_points"] - 1)
    np.testing.assert_allclose(S @ S.T * w, np.eye(3), atol=5e-2)
    mus = [m for _, m in res.mu_table]
    assert mus[0] < mus[1] < mus[2], mus


# the keys of the JAX runner's deflation record (gpe_tpu/experiments/run.py:249-250)
JAX_RECORD = {"experiment", "mu_table", "wall_s"}


@pytest.mark.parametrize("name", ["deflation_harmonic", "deflation_2d"])
def test_run_main_deflation_branch_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    """Each config at a small size (96 points in 1D, 10² in 2D, width 12),
    6 epochs a mode and a 2-step polish: the JAX record's keys (plus
    `seconds`), one finite μ per mode."""
    cfg = EXPERIMENTS[name]
    n = 10 if cfg.spec.dim == 2 else 96
    monkeypatch.setitem(EXPERIMENTS, name, replace(
        cfg, spec=replace(cfg.spec, n_points=n, layers=(cfg.spec.dim, 12, 12, 1))))
    assert run.main([name, "--cpu", "--epochs", "6", "--lm-steps", "2", "--out",
                     str(tmp_path)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == JAX_RECORD | {"seconds"}
    assert [m for m, _ in rec["mu_table"]] == list(range(len(cfg.modes)))
    assert all(math.isfinite(mu) for _, mu in rec["mu_table"])
    assert set(rec["seconds"]["lm"]) == {str(m) for m in range(len(cfg.modes))}
    assert json.loads((tmp_path / name / "summary.json").read_text()) == rec


def test_trainer_oracles_score_the_deflation_ladder(tmp_path, monkeypatch, capsys):
    """The Newton oracle on the config's grid: the linear ladder 2n+1 at
    γ = 0 (the 4th-order stencil on 2000 points, within 1e-6), and the
    scoring CLI on a shortened deflation_harmonic run at γ = 10."""
    from gpe_tpu_torch.experiments import trainer_oracles

    cfg = EXPERIMENTS["deflation_harmonic"]
    refs = trainer_oracles.deflation_oracle(cfg.spec, 0.0, 3, device="cpu")
    np.testing.assert_allclose(refs, [1.0, 3.0, 5.0], atol=1e-6)
    monkeypatch.setitem(EXPERIMENTS, cfg.name, replace(
        cfg, spec=replace(cfg.spec, n_points=96, layers=(1, 12, 12, 1))))
    assert trainer_oracles.main([cfg.name, "--cpu", "--epochs", "4", "--lm-steps", "1",
                                 "--out", str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = trainer_oracles.deflation_oracle(EXPERIMENTS[cfg.name].spec, 10.0, 4,
                                            device="cpu")
    assert [r["mode"] for r in line["oracle"]] == [0, 1, 2, 3]
    assert [r["mu_ref"] for r in line["oracle"]] == want
    assert want[0] < want[1] < want[2] < want[3]
    for r in line["oracle"]:
        near = int(np.argmin([abs(r["mu"] - w) for w in want]))
        assert (r["nearest_mode"], r["nearest_abs_err"]) == (near, abs(r["mu"] - want[near]))
