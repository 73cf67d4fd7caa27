"""Port parity of the continuation trainers — `train_beta_sweep`,
`train_two_stage`, `train_p_ramp` — and their runner branches, against the
JAX package on the CPU at small sizes.

The rung-by-rung parity runs carry the JAX package's initial AND
post-pretraining params over to the port (its L-BFGS pretraining phase
does not follow optax's line search step for step), so both sides train
every rung from the same state: each rung's loss history within rtol 1e-4
and its μ history within rtol 1e-5, the fit-parity bounds of
test_torch_train.py, with the same epochs per rung. The end-to-end runs
pretrain on each side from the same initial params and are held at 3e-3
in μ, as the PL-PINN end-to-end parity of test_torch_families_train.py.
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
from gpe_tpu.train import beta_sweep as jbeta  # noqa: E402
from gpe_tpu.train import p_ramp as jpramp  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu.train import two_stage as jtwo  # noqa: E402
from gpe_tpu.train.pretrain import pretrain_to_base as jpretrain  # noqa: E402
from gpe_tpu_torch.experiments import run  # noqa: E402
from gpe_tpu_torch.experiments.configs import EXPERIMENTS  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import beta_sweep as tbeta  # noqa: E402
from gpe_tpu_torch.train import p_ramp as tpramp  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402
from gpe_tpu_torch.train import two_stage as ttwo  # noqa: E402

SPECS = {
    "gravity_well": dict(lb=0.0, ub=35.0, potential="linear", basis="airy",
                         n_points=200, layers=(1, 16, 16, 1)),
    "box_gaussian": dict(lb=0.0, ub=1.0, potential="gaussian",
                         potential_kwargs=(("sigma", 1.0),), basis="box",
                         hard_bc=True, n_points=200, layers=(1, 16, 16, 1)),
    "harmonic": dict(n_points=200, layers=(1, 16, 16, 1), nonlinearity="abs_power"),
}
BETAS = {"gravity_well": (1.0, 20.0, 40.0), "box_gaussian": (0.0, 0.5, 1.0)}


def _np(params):
    return [(np.asarray(w), np.asarray(b)) for w, b in params]


def _carry(monkeypatch, module, kw, seed=0, pretrain_epochs=30):
    """The JAX package's initial params of `seed` and its pretraining of
    them to the mode-0 base (of the unit potential), carried into the
    port's `module` by monkeypatching its init_mlp and pretrain_to_base."""
    jspec = jprob.GPESpec(**kw)
    init = jmlp.init_mlp(jax.random.PRNGKey(seed), jspec.layers, "xavier_uniform")
    batch = jprob.make_batch(jspec, 0)
    target = np.asarray(jprob.base_triple(jspec, 0, batch["x"]).value)
    pre, mse = jpretrain(init, batch["x"], target, jspec.activation,
                         epochs=pretrain_epochs, lr=1e-3)
    carried_init = params_from_numpy(_np(init), device="cpu")
    carried_pre = params_from_numpy(_np(pre), device="cpu")
    monkeypatch.setattr(module.mlp, "init_mlp", lambda *a, **k: carried_init)
    monkeypatch.setattr(module, "pretrain_to_base", lambda *a, **k: (carried_pre, mse))
    return init


def _hold(t_hist, j_hist):
    np.testing.assert_allclose(t_hist["loss"], np.asarray(j_hist["loss"]), rtol=1e-4)
    np.testing.assert_allclose(t_hist["mu"], np.asarray(j_hist["mu"]), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(BETAS))
def test_train_beta_sweep_matches_jax_rung_by_rung(name, monkeypatch):
    """Three β rungs of 25 epochs (chunks of 10), warm-started across β,
    from JAX's pretrained params: every rung's histories, epochs and μ."""
    kw = SPECS[name]
    _carry(monkeypatch, tbeta, kw)
    run_kw = dict(epochs=25, pretrain_epochs=30, check_every=10)
    jres = jbeta.train_beta_sweep(jprob.GPESpec(**kw), BETAS[name], **run_kw)
    tres = tbeta.train_beta_sweep(tprob.GPESpec(**kw), BETAS[name], device="cpu",
                                  **run_kw)
    assert [b for b, _ in tres.mu_table[0]] == list(BETAS[name])
    np.testing.assert_allclose([m for _, m in tres.mu_table[0]],
                               [m for _, m in jres.mu_table[0]], rtol=1e-5)
    assert tres.epochs_history == jres.epochs_history
    assert tres.constant_history[0] == pytest.approx(jres.constant_history[0], rel=1e-6)
    for beta in BETAS[name]:
        _hold(tres.training_history[0][beta], jres.training_history[0][beta])
    assert set(tres.seconds) == {"pretrain", "fit"}


def test_beta_scales_a_fresh_copy_of_the_unit_batch():
    spec = tprob.GPESpec(**SPECS["gravity_well"])
    batch = tprob.make_batch(spec, 0, device="cpu")
    unit = batch["V"].clone()
    scaled = tbeta.beta_scaled(batch, 0.1)
    assert torch.equal(batch["V"], unit) and scaled["x"] is batch["x"]
    np.testing.assert_array_equal(scaled["V"].numpy(),
                                  unit.numpy() * np.float32(0.1))


def test_train_beta_sweep_end_to_end_matches_jax(monkeypatch):
    """The gravity well with pretraining on each side from JAX's initial
    params (20 pretrain steps, three β rungs of 20 epochs): μ tables within
    3e-3, μ(β=1) within 2e-2 of |a₀| and rising with β."""
    kw = SPECS["gravity_well"]
    init = jmlp.init_mlp(jax.random.PRNGKey(0), kw["layers"], "xavier_uniform")
    carried = params_from_numpy(_np(init), device="cpu")
    monkeypatch.setattr(tbeta.mlp, "init_mlp", lambda *a, **k: carried)
    run_kw = dict(epochs=20, pretrain_epochs=20, check_every=10)
    jres = jbeta.train_beta_sweep(jprob.GPESpec(**kw), BETAS["gravity_well"], **run_kw)
    tres = tbeta.train_beta_sweep(tprob.GPESpec(**kw), BETAS["gravity_well"],
                                  device="cpu", **run_kw)
    tmu = [m for _, m in tres.mu_table[0]]
    jmu = [m for _, m in jres.mu_table[0]]
    np.testing.assert_allclose(tmu, jmu, rtol=3e-3)
    assert abs(tmu[0] - 2.338107410459767) < 2e-2
    assert tmu[0] < tmu[1] < tmu[2]


def test_train_two_stage_matches_jax_and_passes_beta_gamma_as_f32(monkeypatch):
    """β ∈ (1, 1.3) then γ ∈ (0, 2) at β = 1.3, 20 epochs a rung, from JAX's
    pretrained params: every rung's histories and μ; the loss gets γ as an
    f32 scalar and β·V with β rounded to f32."""
    kw = SPECS["harmonic"]
    _carry(monkeypatch, ttwo, kw)
    seen = []
    real = ttwo.make_loss_fn

    def spy(spec):
        inner = real(spec)

        def loss_fn(params, batch, gamma, scale):
            seen.append((gamma, batch["V"]))
            return inner(params, batch, gamma, scale)
        return loss_fn

    monkeypatch.setattr(ttwo, "make_loss_fn", spy)
    run_kw = dict(epochs=20, pretrain_epochs=30, check_every=10)
    jres = jtwo.train_two_stage(jprob.GPESpec(**kw), (1.0, 1.3), (0.0, 2.0), **run_kw)
    tres = ttwo.train_two_stage(tprob.GPESpec(**kw), (1.0, 1.3), (0.0, 2.0),
                                device="cpu", **run_kw)
    for got, want in ((tres.mu_beta, jres.mu_beta), (tres.mu_gamma, jres.mu_gamma)):
        assert [k for k, _ in got] == [k for k, _ in want]
        np.testing.assert_allclose([m for _, m in got], [m for _, m in want], rtol=1e-5)
    assert set(tres.history) == set(jres.history) and tres.epochs == jres.epochs
    for key in jres.history:
        _hold(tres.history[key], jres.history[key])
    V = tprob.make_batch(tprob.GPESpec(**kw), 0, device="cpu")["V"].numpy()
    reached = set()
    for g, v in seen:
        assert g.dtype == torch.float32 and g.ndim == 0
        beta = [b for b in (1.0, 1.3) if np.array_equal(v.numpy(), np.float32(b) * V)]
        assert len(beta) == 1
        reached.add((float(g), beta[0]))
    assert reached == {(0.0, 1.0), (0.0, 1.3), (2.0, 1.3)}


def test_fit_keeps_the_fused_gradient_scalar_gamma_contract():
    """fit passes a non-scalar γ through only without a fused gradient."""
    from gpe_tpu_torch.train.loop import _as_device_f32

    cpu = torch.device("cpu")
    pair = torch.tensor([1.3, 2.0], dtype=torch.float64)
    got = _as_device_f32(pair, cpu, scalar=False)
    assert got.dtype == torch.float32 and got.shape == (2,)
    assert _as_device_f32(2.0, cpu).shape == ()
    assert _as_device_f32(torch.tensor([2.0]), cpu, scalar=False).shape == ()
    with pytest.raises(RuntimeError):
        _as_device_f32(pair, cpu, scalar=True)


def test_train_p_ramp_matches_jax_rung_by_rung(monkeypatch):
    """p ∈ (2, 3, 4) at γ = 2, 20 epochs a rung, from JAX's pretrained
    params: every rung's histories and μ, warm-started across p."""
    kw = SPECS["harmonic"]
    _carry(monkeypatch, tpramp, kw)
    run_kw = dict(epochs=20, pretrain_epochs=30, check_every=10)
    jres = jpramp.train_p_ramp(jprob.GPESpec(**kw), (3.0, 2.0, 4.0), 2.0, **run_kw)
    tres = tpramp.train_p_ramp(tprob.GPESpec(**kw), (3.0, 2.0, 4.0), 2.0, device="cpu",
                               **run_kw)
    assert [p for p, _ in tres.mu_table] == [2.0, 3.0, 4.0]
    np.testing.assert_allclose([m for _, m in tres.mu_table],
                               [m for _, m in jres.mu_table], rtol=1e-5)
    assert tres.epochs_history == jres.epochs_history
    for p in (2.0, 3.0, 4.0):
        _hold(tres.training_history[p], jres.training_history[p])
    # the first rung's best params at test_torch_train.py's 20-step bound
    for (tw, _), (jw, _) in zip(tres.params_by_p[2.0], jres.params_by_p[2.0]):
        np.testing.assert_allclose(tw, np.asarray(jw), atol=1e-5)


# the keys of the JAX runner's records (gpe_tpu/experiments/run.py:193-226)
JAX_RECORDS = {"two_stage": {"experiment", "mu_beta", "mu_gamma", "wall_s"},
               "beta_sweep": {"experiment", "mu_table_tail", "wall_s"},
               "p_ramp": {"experiment", "mu_table", "wall_s"}}
RUN_ARGS = {"vary_beta_harmonic": ["--betas", "0", "0.5"],
            "vary_beta_gravity_well": ["--betas", "1", "20"],
            "vary_beta_box_gaussian": ["--betas", "0", "1"],
            "two_stage_beta_gamma": ["--betas", "1", "1.5", "--gammas", "0", "1"],
            "p_ramp_harmonic": []}


@pytest.mark.parametrize("name", sorted(RUN_ARGS))
def test_run_main_continuation_branches_on_the_cpu(name, tmp_path, monkeypatch,
                                                   capsys):
    """Each config at 96 points and [1,12,12,1], 6 epochs a rung: the JAX
    record's keys (plus `seconds`), the rungs asked for, finite μ, and for
    the β sweeps a bundle that a second call loads."""
    cfg = EXPERIMENTS[name]
    monkeypatch.setitem(EXPERIMENTS, name, replace(
        cfg, spec=replace(cfg.spec, n_points=96, layers=(1, 12, 12, 1))))
    argv = [name, "--cpu", "--epochs", "6", "--pretrain", "10", "--out",
            str(tmp_path)] + RUN_ARGS[name]
    assert run.main(argv + ["--train"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    plot = {"plot"} if cfg.algorithm == "beta_sweep" else set()
    assert set(rec) == JAX_RECORDS[cfg.algorithm] | {"seconds"} | plot
    assert rec["experiment"] == name
    assert json.loads((tmp_path / name / "summary.json").read_text()) == rec
    if cfg.algorithm == "two_stage":
        assert [b for b, _ in rec["mu_beta"]] == [1.0, 1.5]
        assert [g for g, _ in rec["mu_gamma"]] == [0.0, 1.0]
        mus = [m for _, m in rec["mu_beta"] + rec["mu_gamma"]]
    elif cfg.algorithm == "p_ramp":
        assert [p for p, _ in rec["mu_table"]] == list(cfg.p_values)
        mus = [m for _, m in rec["mu_table"]]
    else:
        beta, mu = rec["mu_table_tail"]["0"]
        assert beta == float(RUN_ARGS[name][-1])
        mus = [mu]
        assert run.main(argv) == 0                  # loads the bundle
        again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(again) == JAX_RECORDS["beta_sweep"] | plot
        assert again["mu_table_tail"] == rec["mu_table_tail"]
    assert all(math.isfinite(m) for m in mus)


def test_trainer_oracles_score_the_gravity_well_sweep(tmp_path, monkeypatch, capsys):
    """The exact μₙ(β) = (c·β²)^(1/3)·|αₙ|, and the scoring CLI on a
    shortened sweep: one row per β with its error against it."""
    from gpe_tpu_torch.experiments import trainer_oracles

    a0 = 2.338107410459767
    assert trainer_oracles.gravity_well_mu(1.0) == pytest.approx(a0, rel=1e-12)
    assert trainer_oracles.gravity_well_mu(8.0) == pytest.approx(4.0 * a0, rel=1e-12)
    assert trainer_oracles.gravity_well_mu(1.0, kinetic=8.0) == pytest.approx(2.0 * a0)
    cfg = EXPERIMENTS["vary_beta_gravity_well"]
    monkeypatch.setitem(EXPERIMENTS, cfg.name, replace(
        cfg, spec=replace(cfg.spec, n_points=96, layers=(1, 12, 12, 1))))
    assert trainer_oracles.main([cfg.name, "--cpu", "--epochs", "4", "--pretrain", "10",
                                 "--betas", "1", "8", "--out", str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["beta"] for r in line["oracle"]] == [1.0, 8.0]
    for r in line["oracle"]:
        assert r["mu_ref"] == trainer_oracles.gravity_well_mu(r["beta"])
        assert r["abs_err"] == abs(r["mu"] - r["mu_ref"])
    assert line["max_abs_err"] == max(r["abs_err"] for r in line["oracle"])
