"""Port parity for the box, gravity-well and Gaussian families' training
layer against the JAX package (CPU, small sizes): the loss and its
gradients for the box, gravity-well, Riesz, anti-trivial, self-adaptive,
symmetry and width configurations, the ramp optimizer's lr modes and
`make_optimizer("adam")`, fit() over the self-adaptive params tree,
`_rebase`'s hard-BC and reflect folds, the JAX-trained cross-potential
bundles, `train_plpinn` end to end on a box and a gravity-well spec, and
the runner's `fit` and `cross_potential` branches.

Tolerances: loss values in f64 at rtol 1e-6 / atol 1e-7 and gradients at
normalised atol 1e-5 (the JAX package reduces the loss sums in f32 even
under x64, as in tests/test_torch_train.py); optimizer trajectories in f32
at rtol 1e-6 (the ramp modes bit-equal, make_optimizer's ≤ 1.3e-7); fit() loss histories at rtol 1e-4 as
test_torch_train.py's; the folds in f64 at 1e-12; the bundles' μ at rel
1e-5 (f32 forward-Laplacian sums in another order, as
tests/test_torch_io.py). End to end, the two sides' pretraining runs its
L-BFGS phase by different line searches (optax's zoom, torch's strong
Wolfe), so from the same initial params their μ tables meet at the bound
stated in that test, not to f32 round-off.
"""
import json
import math
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.experiments.configs import EXPERIMENTS as JEXP  # noqa: E402
from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.train import loop as jloop  # noqa: E402
from gpe_tpu.train import optimizers as jopt  # noqa: E402
from gpe_tpu.train import plpinn as jpl  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.experiments import run  # noqa: E402
from gpe_tpu_torch.experiments.configs import EXPERIMENTS  # noqa: E402
from gpe_tpu_torch.io import load_bundle  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import loop as tloop  # noqa: E402
from gpe_tpu_torch.train import optimizers as topt  # noqa: E402
from gpe_tpu_torch.train import plpinn as tpl  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _net(layers, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0.0, 1.0 / np.sqrt(i), (i, o)), rng.normal(0.0, 0.1, o))
            for i, o in zip(layers[:-1], layers[1:])]


def _small(name, **kw):
    """A registered config's spec, cut to a few points and a narrow net."""
    spec = EXPERIMENTS[name].spec
    n = 12 if spec.dim == 2 else 128
    return {**{f: getattr(spec, f) for f in (
        "lb", "ub", "dim", "activation", "potential", "potential_kwargs", "basis",
        "p", "kinetic", "nonlinearity", "objective", "bc_weight", "norm_weight",
        "riesz_weight", "symmetry", "sym_weight", "anti_trivial",
        "anti_trivial_weight", "weighting", "use_perturbation", "hard_bc",
        "geometry", "n_boundary", "width_weight", "pde_weight")},
        "n_points": n, "layers": (spec.dim, 12, 12, 1), **kw}


LOSS_SPECS = {
    "box_paper": _small("box_paper"),
    "gravity_well_paper": _small("gravity_well_paper"),
    "gaussian_paper": _small("gaussian_paper"),
    "riesz_mode0": _small("riesz_mode0"),
    "gpe2d_anti_trivial": _small("gpe2d_anti_trivial"),
    "gpe2d_circle": _small("gpe2d_circle"),
    "harmonic_self_adaptive": _small("harmonic_self_adaptive"),
    "self_adaptive_box_sym": _small("box_paper", weighting="self_adaptive",
                                    symmetry="even", sym_weight=3.0),
    "y_even_riesz_width": dict(dim=2, lb=-6.0, ub=6.0, n_points=10, layers=(2, 12, 1),
                               activation="tanh", kinetic=0.5, nonlinearity="abs_power",
                               use_perturbation=False, symmetry="y_even",
                               sym_weight=500.0, riesz_weight=1.0, width_weight=0.3,
                               potential_kwargs=(("a", 0.5),)),
    "odd_l2_shift": dict(n_points=96, layers=(1, 12, 1), symmetry="odd", sym_weight=2.0,
                         norm_style="l2", mu_report_shift=1.0),
}


def _params(spec_kw, seed=0):
    """numpy params for a spec: the MLP's pairs, and for self-adaptive
    weighting {"net", "log_alpha"} with non-zero log-weights."""
    net = _net(spec_kw["layers"], seed)
    if spec_kw.get("weighting") != "self_adaptive":
        return net
    names = tprob.GPESpec(**spec_kw).loss_weights()
    return {"net": net, "log_alpha": {k: np.float64(0.1 * (i + 1) * (-1) ** i)
                                      for i, k in enumerate(names)}}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_to_jax(v) for v in tree)
    return jnp.asarray(tree)


def _flat_np(tree):
    if isinstance(tree, dict):
        return {k: _flat_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flat_np(v) for v in tree]
    return np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree)


def _assert_grads(t, j, path=""):
    if isinstance(j, dict):
        assert sorted(t) == sorted(j), path
        for k in j:
            _assert_grads(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, (list, tuple)):
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_grads(a, b, f"{path}/{i}")
    else:
        s = np.max(np.abs(j)) + 1e-30
        np.testing.assert_allclose(np.asarray(t) / s, np.asarray(j) / s, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("name", sorted(LOSS_SPECS))
def test_loss_and_grads_match_jax_f64(name):
    kw = LOSS_SPECS[name]
    gamma, scale = 3.0, 0.05
    p = _params(kw)
    with jax.enable_x64(True):
        jspec = jprob.GPESpec(**kw, dtype=jnp.float64)
        jbatch = jprob.make_batch(jspec, 1)
        (jt, jaux), jg = jax.value_and_grad(jprob.make_loss_fn(jspec), has_aux=True)(
            _to_jax(p), jbatch, gamma, scale)
        jt, jaux, jg = float(jt), {k: float(v) for k, v in jaux.items()}, _flat_np(
            jax.tree.map(np.asarray, jg))
    tspec = tprob.GPESpec(**kw, dtype=torch.float64)
    tbatch = tprob.make_batch(tspec, 1, device="cpu")
    (tt, taux), tg = tloop.value_and_grad(tprob.make_loss_fn(tspec))(
        params_from_numpy(p, device="cpu", dtype=torch.float64), tbatch, gamma, scale)
    np.testing.assert_allclose(float(tt), jt, rtol=1e-6)
    assert sorted(taux) == sorted(jaux)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(taux[k]), v, rtol=1e-6, atol=1e-7, err_msg=k)
    _assert_grads(_flat_np(tg), jg)
    if isinstance(p, dict):
        # the ascent trick: d total / d log α_k = −w_k·exp(log α_k)·L_k, the
        # opposite sign of plain minimisation of the weighted sum
        weights = tspec.loss_weights()
        for k, la in p["log_alpha"].items():
            want = -weights[k] * math.exp(la) * float(taux[k])
            np.testing.assert_allclose(float(tg["log_alpha"][k]), want, rtol=1e-9)
            assert np.sign(jg["log_alpha"][k]) == np.sign(want)


LR_MODES = ["loss_faithful", "cosine", "constant", "warmup_faithful", "warmup_cosine"]


def _trajectory(opt, params, grads, losses, update_fn):
    out = []
    state = opt.init(params)
    for g, v in zip(grads, losses):
        u, state = update_fn(opt, g, state, params, v)
        params = u
        out.append(params)
    return out


@pytest.mark.parametrize("mode", LR_MODES + ["adam_float", "adam_schedule"])
def test_ramp_optimizer_modes_match_optax(mode):
    """Ten updates from the same params, gradients (norms above and below
    the clip) and losses (below 1 and past T₀ = 200, where the
    loss-faithful schedule restarts): the params after every update."""
    rng = np.random.default_rng(len(mode))
    p0 = [(rng.normal(size=(1, 6)).astype(np.float32), rng.normal(size=6).astype(np.float32))]
    grads = [[(rng.normal(0.0, s, (1, 6)).astype(np.float32),
               rng.normal(0.0, s, 6).astype(np.float32))]
             for s in (0.1, 2.0, 0.5, 3.0, 0.01, 1.0, 0.2, 5.0, 0.3, 0.05)]
    losses = np.array([0.5, 250.0, 3.0, 0.01, 410.0, 90.0, 1.5, 600.0, 0.2, 20.0],
                      np.float32)
    if mode == "adam_float":
        jo, to = (jopt.make_optimizer("adam", 2e-3, clip_norm=1.0),
                  topt.make_optimizer("adam", 2e-3, clip_norm=1.0))
    elif mode == "adam_schedule":
        from gpe_tpu.train.schedules import cosine_warm_restarts as jcwr
        from gpe_tpu_torch.train.schedules import cosine_warm_restarts as tcwr
        jo = jopt.make_optimizer("adam", jcwr(1e-3, 3, 2, 1e-5))
        to = topt.make_optimizer("adam", tcwr(1e-3, 3, 2, 1e-5))
    else:
        jo, to = jpl.ramp_optimizer(1e-3, mode), tpl.ramp_optimizer(1e-3, mode)
    import optax
    jx = optax.with_extra_args_support(jo)

    def jstep(opt, g, state, params, v):
        u, state = jx.update(_to_jax(g), state, params, value=jnp.float32(v))
        return optax.apply_updates(params, u), state

    def tstep(opt, g, state, params, v):
        u, state = opt.update(params_from_numpy(g, device="cpu"), state,
                              torch.tensor(v))
        return tuple((w + uw, b + ub) for (w, b), (uw, ub) in zip(params, u)), state

    want = _trajectory(jx, _to_jax(p0), grads, losses, jstep)
    got = _trajectory(to, params_from_numpy(p0, device="cpu"), grads, losses, tstep)
    for k, (a, b) in enumerate(zip(got, want)):
        for (tw, tb), (jw, jb) in zip(a, b):
            for x, y in ((tw, jw), (tb, jb)):
                np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                           atol=1e-9, err_msg=f"update {k}")
    if mode.startswith("warmup"):
        # optax's schedule count is 0 at the first update: no step at all
        np.testing.assert_array_equal(got[0][0][0].numpy(), p0[0][0])


def test_fit_over_the_self_adaptive_tree_matches_jax():
    """fit() with {"net", "log_alpha"} params and make_optimizer("adam"):
    20 steps in chunks of 8 and a tail of 4; the log-weights climb."""
    kw = _small("harmonic_self_adaptive", n_points=96)
    p = _params(kw, 2)
    jspec, tspec = jprob.GPESpec(**kw), tprob.GPESpec(**kw)
    jbatch = jprob.make_batch(jspec, 0)
    tbatch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    run_kw = dict(epochs=20, tol=-1.0, patience=10 ** 9, check_every=8)
    jres = jloop.fit(jprob.make_loss_fn(jspec), jopt.make_optimizer("adam", 1e-3, clip_norm=1.0),
                     jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), _to_jax(p)),
                     jbatch, 2.0, 1.0, **run_kw)
    tres = tloop.fit(tprob.make_loss_fn(tspec), topt.make_optimizer("adam", 1e-3, clip_norm=1.0),
                     params_from_numpy(p, device="cpu"), tbatch, 2.0, 1.0, **run_kw)
    assert tres.epochs_run == jres.epochs_run == 20
    np.testing.assert_allclose(tres.loss_history, jres.loss_history, rtol=1e-4)
    np.testing.assert_allclose(tres.mu_best, jres.mu_best, rtol=1e-5)
    for k, v in tres.final_params["log_alpha"].items():
        jv = float(jres.final_params["log_alpha"][k])
        np.testing.assert_allclose(float(v), jv, rtol=1e-5, atol=1e-7, err_msg=k)
        assert float(v) > p["log_alpha"][k]          # the ascent on every term
    for (tw, _), (jw, _) in zip(tres.params["net"], jres.params["net"]):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


REBASE_SPECS = {
    "hard_bc": dict(lb=0.0, ub=1.0, n_points=64, layers=(1, 12, 12, 1), basis="box",
                    potential="box", hard_bc=True),
    "reflect": dict(n_points=64, layers=(1, 12, 12, 1), symmetry="even",
                    sym_weight=1.0),
    "hard_bc_reflect": dict(lb=0.0, ub=1.0, n_points=64, layers=(1, 12, 12, 1),
                            basis="box", potential="box", hard_bc=True,
                            symmetry="interval", sym_weight=1.0),
}


@pytest.mark.parametrize("name", sorted(REBASE_SPECS))
def test_rebase_folds_match_jax(name):
    """The folded base arrays through the loss's ansatz (sine factor
    included) and the reflected base, f64; the new last layer is each
    side's own draw."""
    kw = REBASE_SPECS[name]
    p = _net(kw["layers"], 7)
    with jax.enable_x64(True):
        jspec = jprob.GPESpec(**kw, dtype=jnp.float64)
        jb, jp = jpl._rebase(jspec, jprob.make_batch(jspec, 1), _to_jax(p), 0.04,
                             jax.random.PRNGKey(0))
        jb = {k: np.asarray(v) for k, v in jb.items()}
    tspec = tprob.GPESpec(**kw, dtype=torch.float64)
    tb, tp = tpl._rebase(tspec, tprob.make_batch(tspec, 1, device="cpu"),
                         params_from_numpy(p, device="cpu", dtype=torch.float64), 0.04,
                         torch.Generator().manual_seed(0))
    assert sorted(tb) == sorted(jb)
    for k in jb:
        np.testing.assert_allclose(tb[k].numpy(), jb[k], rtol=1e-12, atol=1e-13,
                                   err_msg=k)
    if kw.get("hard_bc"):
        # the folded base still vanishes on the walls
        assert np.max(np.abs(tb["base_bval"].numpy())) < 1e-12
    for (tw, tbias), (w, b) in zip(tp[:-1], p[:-1]):
        np.testing.assert_array_equal(tw.numpy(), w)
    assert torch.all(tp[-1][1] == 0) and float(tp[-1][0].abs().max()) < 1e-2


def _cross_mu_jax(label):
    from gpe_tpu.experiments.configs import _PAPER_1D
    jfams = {"harmonic": _PAPER_1D,
             "box": replace(_PAPER_1D, lb=0.0, ub=1.0, potential="box", basis="box",
                            hard_bc=True),
             "gravity_well": replace(_PAPER_1D, lb=0.0, ub=35.0, potential="linear",
                                     basis="airy"),
             "gaussian": replace(_PAPER_1D, potential="gaussian")}
    bundle = load_bundle(str(ROOT / "runs" / "mode0_all_potentials" / f"{label}_bundle.pkl"))
    g = sorted(bundle["params_by_mode"][0])[-1]
    scale = JEXP["mode0_all_potentials"].perturb_const / bundle["constant_history"][0]
    with jax.default_matmul_precision("highest"):
        mu = jprob.make_loss_fn(jfams[label])(
            _to_jax(bundle["params_by_mode"][0][g]), jprob.make_batch(jfams[label], 0),
            jnp.float32(g), jnp.float32(scale))[1]["mu"]
    return bundle, g, scale, float(mu)


@pytest.mark.parametrize("label", ["harmonic", "box", "gravity_well", "gaussian"])
def test_cross_potential_bundles_match_jax(label):
    """The JAX-trained mode0_all_potentials bundles (γ = 10 params and their
    normal_const) on batches the port rebuilds: μ on the port's plain f32
    path against the JAX package's f32 CPU μ, and the constant that
    chip_smoke.py holds the card's μ to is that JAX value."""
    import chip_smoke

    bundle, g, scale, want = _cross_mu_jax(label)
    assert g == 10.0
    spec = run.cross_potential_families(EXPERIMENTS["mode0_all_potentials"].spec)[label]
    assert spec.hard_bc == (label == "box")
    with torch.no_grad():
        got = float(tprob.make_loss_fn(spec)(
            params_from_numpy(bundle["params_by_mode"][0][g], device="cpu"),
            tprob.make_batch(spec, 0, device="cpu"), g, scale)[1]["mu"])
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert chip_smoke.CROSS_BUNDLE_MU[label] == pytest.approx(want, rel=1e-7)


E2E = {"box": dict(lb=0.0, ub=1.0, potential="box", basis="box", hard_bc=True,
                   exact=math.pi ** 2),
       "gravity_well": dict(lb=0.0, ub=35.0, potential="linear", basis="airy",
                            exact=2.338107410459767)}


@pytest.mark.parametrize("name", sorted(E2E))
def test_train_plpinn_end_to_end_matches_jax(name, monkeypatch):
    """200 points, (1,16,16,1), rungs γ ∈ {0, 1} of 20 epochs, 20 pretrain
    steps, rebase, from the JAX package's initial params on both sides: the
    two μ tables within 3e-3 relative of each other (measured: 1.5e-5 box,
    9.4e-4 gravity well — both pretrainings run optax's L-BFGS, whose f32
    line search amplifies the two sides' round-off; 1.5e-4 and 1.1e-3 with
    torch's strong-Wolfe L-BFGS before), μ at γ = 0 within 2e-2 of the exact eigenvalue on
    both sides (this narrow, briefly pretrained net sits 2e-5 off π² and
    6e-3–9e-3 off −α₀ on either side) and μ rising with γ."""
    kw = {k: v for k, v in E2E[name].items() if k != "exact"}
    kw.update(n_points=200, layers=(1, 16, 16, 1))
    run_kw = dict(gamma_values=(0.0, 1.0), epochs=20, pretrain_epochs=20,
                  check_every=10, rebase=True)
    init = jmlp.init_mlp(jax.random.PRNGKey(0), kw["layers"], "xavier_uniform")
    jres = jpl.train_plpinn(jprob.GPESpec(**kw), **run_kw)
    carried = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in init],
                                device="cpu")
    monkeypatch.setattr(tpl.mlp, "init_mlp", lambda *a, **k: carried)
    tres = tpl.train_plpinn(tprob.GPESpec(**kw), device="cpu", **run_kw)
    jmu = [m for _, m in jres.mu_table[0]]
    tmu = [m for _, m in tres.mu_table[0]]
    exact = E2E[name]["exact"]
    assert abs(tmu[0] - exact) < 2e-2 and abs(jmu[0] - exact) < 2e-2, (tmu, jmu)
    assert tmu[1] > tmu[0]
    np.testing.assert_allclose(tmu, jmu, rtol=3e-3)


def _tiny(name, **kw):
    cfg = EXPERIMENTS[name]
    n = 10 if cfg.spec.dim == 2 else 96
    return replace(cfg, spec=replace(cfg.spec, n_points=n,
                                     layers=(cfg.spec.dim, 12, 12, 1)), **kw)


@pytest.mark.parametrize("name", ["gpe2d_circle", "harmonic_self_adaptive", "riesz_mode0",
                                  "gpe2d_anti_trivial"])
def test_run_main_fit_branch_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    """The JAX record's keys per γ (plus `seconds`), the JAX runner's
    summary.json layout, and μ of the normalised state for vanilla specs."""
    monkeypatch.setitem(EXPERIMENTS, name, _tiny(name))
    assert run.main([name, "--cpu", "--epochs", "6", "--out", str(tmp_path)]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()
             if s.startswith("{")]
    gammas = list(EXPERIMENTS[name].gamma_values)
    assert [r["gamma"] for r in lines] == gammas
    for r in lines:
        assert set(r) == {"gamma", "mu", "loss", "epochs", "seconds"}
        assert r["epochs"] == 6 and math.isfinite(r["mu"]) and math.isfinite(r["loss"])
    summary = json.loads((tmp_path / name / "summary.json").read_text())
    assert summary == (lines if len(lines) != 1 else lines[0])


def test_run_main_cross_potential_branch_on_the_cpu(tmp_path, monkeypatch, capsys):
    """One record per family with the JAX record's keys (plus `seconds`
    when it trained, and `plot`, the figure over the four families), the
    four bundles, and a second call that loads them."""
    monkeypatch.setitem(EXPERIMENTS, "mode0_all_potentials", _tiny("mode0_all_potentials"))
    argv = ["mode0_all_potentials", "--cpu", "--epochs", "5", "--pretrain", "5",
            "--gammas", "0", "1", "--out", str(tmp_path)]
    assert run.main(argv + ["--train"]) == 0
    recs = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()
            if s.startswith("{")]
    assert [r["potential"] for r in recs] == ["harmonic", "box", "gravity_well", "gaussian"]
    for r in recs:
        assert set(r) == {"potential", "mu_final", "gamma0_final_loss", "seconds", "plot"}
        assert r["plot"] == ["mode0_cross_potential.png"]
        assert r["mu_final"][0] == 1.0 and math.isfinite(r["mu_final"][1])
        assert (tmp_path / "mode0_all_potentials" / f"{r['potential']}_bundle.pkl").exists()
    assert run.main(argv) == 0
    again = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()
             if s.startswith("{")]
    assert again == [{k: v for k, v in r.items() if k != "seconds"} for r in recs]
    assert json.loads((tmp_path / "mode0_all_potentials" / "summary.json").read_text()) == again


def test_fused_gate_follows_jax():
    """The fused kernels take the gravity-well and Gaussian-trap families
    and decline the hard-BC, disk, Riesz, anti-trivial and self-adaptive
    configurations, as the JAX package's gate does; off the card there is
    no fused path at all."""
    from gpe_tpu_torch.experiments.paper_tables import family

    takes = {"gravity_well_paper", "gaussian_paper", "harmonic_paper"}
    declines = {"box_paper", "gpe2d_circle", "riesz_mode0", "gpe2d_anti_trivial",
                "harmonic_self_adaptive"}
    for name in takes | declines:
        assert tprob._fused_loss(EXPERIMENTS[name].spec) == (name in takes), name
    assert tprob._fused_loss(family("p3_gravity_well")["spec"])
    for fam in ("p3_box", "p3_gaussian"):
        assert not tprob._fused_loss(family(fam)["spec"])
        assert not tprob.packed_eligible(family(fam)["spec"], 2)
    assert tprob.packed_eligible(family("p3_gravity_well")["spec"], 2)
    assert tprob.make_fused_value_and_grad(EXPERIMENTS["gravity_well_paper"].spec,
                                           device="cpu") is None


def test_seed_stats_packed_branch_takes_the_gravity_well(tmp_path, monkeypatch):
    """The CLI on a reduced p3_gravity_well family (two seeds, a 3-rung
    ramp) through the run-stacked ensemble, scored against the committed
    oracle; the hard-BC families (reduced alike) through fit_ensemble."""
    from gpe_tpu_torch.experiments import seed_stats as tss

    fam = tss.get_family("p3_gravity_well")
    small = dict(fam, spec=replace(fam["spec"], n_points=256, layers=(1, 16, 16, 1)))
    monkeypatch.setattr(tss, "get_family", lambda name: small)
    out = tmp_path / "stats.json"
    assert tss.main(["--family", "p3_gravity_well", "--modes", "1", "--n-seeds", "2",
                     "--epochs", "5", "--ramp-step", "50", "--device", "cpu",
                     "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    rows = res["modes"]["1"]["PL-PINN"]["rows"]
    assert [r["gamma"] for r in rows] == [0.0, 100.0]
    assert abs(rows[0]["mu_ref"] - 4.087949444130970) < 1e-6      # −α₁
    assert all(abs(m - rows[0]["mu_ref"]) < 5e-2 for m in rows[0]["mu_seeds"])
    monkeypatch.undo()
    for name in ("p3_box", "p3_gaussian"):
        fam = tss.get_family(name)
        monkeypatch.setattr(tss, "get_family", lambda _, fam=fam: dict(
            fam, spec=replace(fam["spec"], n_points=96, layers=(1, 8, 8, 1))))
        res = tss.run_seed_stats(name, modes=(0,), n_seeds=2, epochs=2, ramp_step=50.0,
                                 device="cpu", out_path=str(tmp_path / f"{name}.json"),
                                 verbose=False)
        for method in ("PL-PINN", "PL-PINN-R"):
            rows = res["modes"]["0"][method]["rows"]
            assert [r["gamma"] for r in rows] == [0.0, 100.0]
            assert all(len(r["mu_seeds"]) == 2 and np.isfinite(r["mu_seeds"]).all()
                       for r in rows)
