"""Port parity of the method comparison: `fit_ensemble` (its plain and fused
routes), the per-run optimizer, `pretrain_to_base(apply_fn=)`, the compare
functions of `train/compare.py`, `utils/metrics.py`, `paper_tables`'s
oracle and `run_family`, the runner's `compare` branch and the hard-BC seed
ensemble, against the JAX package on the CPU (f32, small sizes).

Initial params are made with numpy from a seed (or by the JAX package) and
carried across with `params_from_numpy`. Tolerances: f32 training
trajectories at loss rtol 1e-4 and μ rtol 1e-5 (tests/test_torch_train.py's
fit parity); optimizer updates rtol 1e-6; the end-to-end compare functions
at 3e-3, the gap the two pretrainings' L-BFGS phases open (ROADMAP Queue 3);
the float64 oracle at atol 1e-14 against the committed tables.
"""
import csv
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
import optax  # noqa: E402

from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.pallas.fused_grad import make_pallas_value_and_grad  # noqa: E402
from gpe_tpu.train import compare as jcompare  # noqa: E402
from gpe_tpu.train import loop as jloop  # noqa: E402
from gpe_tpu.train import plpinn as jpl  # noqa: E402
from gpe_tpu.train import pretrain as jpre  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.experiments import paper_tables as tpt  # noqa: E402
from gpe_tpu_torch.experiments import run  # noqa: E402
from gpe_tpu_torch.experiments import seed_stats as tss  # noqa: E402
from gpe_tpu_torch.experiments.configs import EXPERIMENTS  # noqa: E402
from gpe_tpu_torch.kernels import fused_grad as k2  # noqa: E402
from gpe_tpu_torch.models.ansatz import box_sine_factor  # noqa: E402
from gpe_tpu_torch.models.mlp import mlp_apply, params_from_numpy, run_slice  # noqa: E402
from gpe_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from gpe_tpu_torch.train import compare as tcompare  # noqa: E402
from gpe_tpu_torch.train import loop as tloop  # noqa: E402
from gpe_tpu_torch.train import plpinn as tpl  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402
from gpe_tpu_torch.train.optimizers import make_optimizer  # noqa: E402
from gpe_tpu_torch.train.pretrain import pretrain_to_base  # noqa: E402
from gpe_tpu_torch.train.schedules import cosine_warm_restarts  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(n_points=512, layers=(1, 24, 24, 1))          # tests/test_trainers.py
TINY = dict(n_points=128, layers=(1, 12, 12, 1))
BOX = dict(lb=0.0, ub=1.0, potential="box", basis="box", hard_bc=True)
LR_MODES = ("loss_faithful", "cosine", "constant", "warmup_faithful", "warmup_cosine")


def _np_params(layers, seed, R=None):
    """numpy MLP params (a leading run axis R when given)."""
    rng = np.random.default_rng(seed)
    lead = () if R is None else (R,)
    return [(rng.uniform(-1.0, 1.0, lead + (k, m)).astype(np.float32)
             * np.float32(np.sqrt(6.0 / (k + m))),
             np.full(lead + (m,), 0.01, np.float32))
            for k, m in zip(layers[:-1], layers[1:])]


def _j(params):
    return tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in params)


def _t(params):
    return params_from_numpy(params, device="cpu")


def _batches(kw, mode=0):
    jspec, tspec = jprob.GPESpec(**kw), tprob.GPESpec(**kw)
    jb = jprob.make_batch(jspec, mode)
    return jspec, tspec, jb, {k: torch.as_tensor(np.array(v)) for k, v in jb.items()}


# ---- fit_ensemble, plain route ---------------------------------------------

def _ens_case():
    jspec, tspec, jb, tb = _batches(SMALL)
    runs = _np_params(SMALL["layers"], 3, R=3)
    gammas = np.array([0.0, 1.0, 2.5], np.float32)
    scales = np.array([0.01, 0.02, 0.05], np.float32)
    return jspec, tspec, jb, tb, runs, gammas, scales


def _both_ensembles(lr_mode, lr, **kw):
    jspec, tspec, jb, tb, runs, gammas, scales = _ens_case()
    jr = jloop.fit_ensemble(jprob.make_loss_fn(jspec), jpl.ramp_optimizer(lr, lr_mode),
                            _j(runs), jb, jnp.asarray(gammas), jnp.asarray(scales), **kw)
    tr = tloop.fit_ensemble(tprob.make_loss_fn(tspec), tpl.ramp_optimizer(lr, lr_mode),
                            _t(runs), tb, gammas, scales, **kw)
    return jr, tr


def _assert_ensembles_match(tr, jr):
    np.testing.assert_array_equal(tr.epochs_run, jr.epochs_run)
    assert tr.loss_history.shape == jr.loss_history.shape
    np.testing.assert_allclose(tr.loss_history, jr.loss_history, rtol=1e-4)
    np.testing.assert_allclose(tr.mu_history, jr.mu_history, rtol=1e-5)
    np.testing.assert_allclose(tr.best_loss, jr.best_loss, rtol=1e-4)
    np.testing.assert_allclose(tr.mu_best, jr.mu_best, rtol=1e-5)
    np.testing.assert_allclose(tr.mu, jr.mu, rtol=1e-5)


@pytest.mark.parametrize("lr_mode", ["loss_faithful", "warmup_cosine"])
def test_fit_ensemble_plain_route_matches_jax(lr_mode):
    """SMALL, three seeds with per-run γ and scale, 60 steps in chunks of
    25 and a tail of 10, the full budget."""
    jr, tr = _both_ensembles(lr_mode, 1e-3, epochs=60, tol=0.0, patience=10 ** 9,
                             check_every=25)
    assert list(tr.epochs_run) == [60, 60, 60]
    _assert_ensembles_match(tr, jr)


def test_fit_ensemble_early_stop_per_run_matches_jax():
    """tol between two of one run's losses, below every loss of the other
    runs: that run stops there, the others run on; each run's stop epoch,
    truncated history and restored best state as in JAX."""
    jr0, _ = _both_ensembles("loss_faithful", 1e-3, epochs=60, tol=0.0,
                             patience=10 ** 9, check_every=25)
    lows = jr0.loss_history.min(axis=1)
    r = int(np.argmin(lows))
    others = float(np.delete(lows, r).min())
    h = jr0.loss_history[r]
    for i in range(1, 60):
        upper = min(float(h[:i].min()), others)
        if h[i] < upper * (1 - 2e-3):
            tol = float(np.sqrt(h[i] * upper))
            break
    jr, tr = _both_ensembles("loss_faithful", 1e-3, epochs=60, tol=tol,
                             patience=10 ** 9, check_every=25)
    want = [60, 60, 60]
    want[r] = i
    assert list(tr.epochs_run) == want
    _assert_ensembles_match(tr, jr)


def test_fit_ensemble_patience_per_run_matches_jax():
    """A large constant LR makes the losses oscillate: patience 4 stops the
    runs at their own epochs, as in JAX."""
    jr, tr = _both_ensembles("constant", 5e-2, epochs=60, tol=0.0, patience=4,
                             check_every=25)
    assert (tr.epochs_run < 60).any()
    _assert_ensembles_match(tr, jr)


# ---- fit_ensemble, fused route ---------------------------------------------

GRAD_SPEC = dict(n_points=256, layers=(1, 32, 32, 1), potential="harmonic",
                 lb=-8.0, ub=8.0, nonlinearity="power", use_perturbation=True,
                 basis="hermite", activation="tanh")     # tests/test_pallas_grad.py


def _relaxed_kw(spec):
    return dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
                nonlinearity=spec.nonlinearity, bc_weight=spec.bc_weight,
                norm_weight=spec.norm_weight, delayed=True, extrapolate=True,
                fresh_values=True)


def test_run_axis_relaxed_vag_matches_vmapped_jax():
    """The single-run relaxed vag's run-mode twin (`.run_axis`, the plain
    versions of K3 on the CPU) over three steps of three runs with per-run
    γ and scale, the same params at every step: against the single-run vag
    run by run at tests/test_pallas_grad.py's vmap tolerances (totals rtol
    1e-6, grads rtol 1e-5 / atol 1e-7), and against jax.vmap of the JAX
    package's interpret-mode relaxed vag at the cross-package f32 bounds of
    tests/test_torch_packed.py (totals rtol 2e-5, μ 1e-5, grads normalised
    2e-4): the two packages sum in other orders, and the pde term's
    cancellation turns ~1e-7 in the sums into up to 1.3e-5 in a total."""
    jspec, tspec, jb, tb = _batches(GRAD_SPEC)
    kw = _relaxed_kw(jspec)
    jvag = make_pallas_value_and_grad(jspec.layers, tile=128, sum_tile=256,
                                      interpret=True, **kw)
    single = k2.make_value_and_grad(tspec.layers, **kw)
    twin = single.run_axis
    runs = _np_params(GRAD_SPEC["layers"], 5, R=3)
    gammas = np.array([0.5, 2.0, 4.0], np.float32)
    scales = np.array([0.01, 0.02, 0.05], np.float32)
    jg, js = jnp.asarray(gammas), jnp.asarray(scales)
    tg, ts = torch.as_tensor(gammas), torch.as_tensor(scales)
    jp = _j(runs)
    jstate = jax.vmap(jvag.init_state, in_axes=(0, None, 0, 0))(jp, jb, jg, js)
    tstate = twin.init_state(_t(runs), tb, tg, ts)
    sstates = [single.init_state(run_slice(_t(runs), r), tb, tg[r], ts[r])
               for r in range(3)]
    jstep = jax.vmap(jvag, in_axes=(0, None, 0, 0, 0))
    for _ in range(3):
        (jt, jaux), jgr, jstate = jstep(jp, jb, jg, js, jstate)
        tp = _t([(np.asarray(w), np.asarray(b)) for w, b in jp])
        (tt, taux), tgr, tstate = twin(tp, tb, tg, ts, tstate)
        for r in range(3):
            (st, saux), sgr, sstates[r] = single(run_slice(tp, r), tb, tg[r], ts[r],
                                                 sstates[r])
            np.testing.assert_allclose(float(tt[r]), float(st), rtol=1e-6)
            np.testing.assert_allclose(float(taux["mu"][r]), float(saux["mu"]), rtol=1e-6)
            for (gw, gb), (sw, sb) in zip(run_slice(tgr, r), sgr):
                np.testing.assert_allclose(gw.numpy(), sw.numpy(), rtol=1e-5, atol=1e-7)
                np.testing.assert_allclose(gb.numpy(), sb.numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2e-5)
        np.testing.assert_allclose(taux["mu"].numpy(), np.asarray(jaux["mu"]), rtol=1e-5)
        for (gw, gb), (ww, wb) in zip(tgr, jgr):
            for a, b in ((gw.numpy(), np.asarray(ww)), (gb.numpy(), np.asarray(wb))):
                top = np.abs(b).max(axis=tuple(range(1, b.ndim)), keepdims=True)
                np.testing.assert_allclose(a / top, b / top, atol=2e-4)
        jp = jax.tree.map(lambda a, g: a - 1e-2 * g, jp, jgr)


def test_fit_ensemble_fused_route_matches_single_fits():
    """fit_ensemble with a single-run relaxed vag steps its run-mode twin:
    three runs, per-run γ and scale, against three `fit` calls with the
    single-run vag (the kernels' plain versions on the CPU)."""
    _, tspec, _, tb = _batches(GRAD_SPEC)
    vag = k2.make_value_and_grad(tspec.layers, **_relaxed_kw(tspec))
    runs = _t(_np_params(GRAD_SPEC["layers"], 6, R=3))
    gammas, scales = [0.0, 2.0, 5.0], [0.01, 0.03, 0.05]
    loss_fn = tprob.make_loss_fn(tspec)
    kw = dict(epochs=30, tol=0.0, patience=10 ** 9, check_every=20)
    ens = tloop.fit_ensemble(loss_fn, tpl.ramp_optimizer(1e-3), runs, tb, gammas, scales,
                             value_and_grad_fn=vag, **kw)
    for r in range(3):
        one = tloop.fit(loss_fn, tpl.ramp_optimizer(1e-3), run_slice(runs, r), tb,
                        gammas[r], scales[r], value_and_grad_fn=vag, **kw)
        np.testing.assert_allclose(ens.loss_history[r], one.loss_history, rtol=1e-4)
        np.testing.assert_allclose(ens.mu_history[r], one.mu_history, rtol=1e-5)
        np.testing.assert_allclose(ens.mu_best[r], one.mu_best, rtol=1e-5)
        assert ens.epochs_run[r] == one.epochs_run


def test_fit_ensemble_refuses_a_vag_without_a_twin_and_a_mesh():
    _, tspec, _, tb = _batches(TINY)
    runs = _t(_np_params(TINY["layers"], 0, R=2))
    loss_fn = tprob.make_loss_fn(tspec)
    with pytest.raises(ValueError, match="run_axis"):
        tloop.fit_ensemble(loss_fn, tpl.ramp_optimizer(), runs, tb, 0.0, 0.01,
                           epochs=2, value_and_grad_fn=tloop.value_and_grad(loss_fn))
    # a mesh the runs do not divide over (the seeds shard over its ranks)
    mesh = Mesh(None, 0, 4, ("ens",), torch.device("cpu"))
    for call in (lambda: tloop.fit_ensemble(loss_fn, tpl.ramp_optimizer(), runs, tb,
                                            0.0, 0.01, epochs=2, mesh=mesh),
                 lambda: tcompare.train_multiple_runs(tspec, 0.0, n_runs=2, epochs=2,
                                                      pretrain_epochs=1, mesh=mesh,
                                                      device="cpu")):
        with pytest.raises(ValueError, match="run count 2 does not divide"):
            call()


# ---- mirrors of the JAX package's toy tests --------------------------------

class _SGD:
    """optax.sgd(lr) in the port's optimizer contract (elementwise, so its
    per-run form is itself)."""

    def __init__(self, lr):
        self.lr = lr

    def per_run_form(self):
        return self

    def init(self, params):
        return ()

    def update(self, grads, state, value):
        return {k: -self.lr * g for k, g in grads.items()}, state


def _counting_loss(params, batch, gamma, scale):
    total = torch.sum(params["w"]) * 1.0 + 0.0 * gamma + 0.0 * scale
    return total, {"mu": total}


def _scale_loss(params, batch, gamma, scale):
    total = (params["w"] - scale) ** 2
    return total, {"mu": scale + 0.0 * total}


def test_fit_ensemble_per_run_scales():
    """tests/test_loop_budget.py: each run converges to its own scale."""
    scales = [0.5, 1.0, 2.0, 4.0]
    ens = tloop.fit_ensemble(_scale_loss, _SGD(0.1), {"w": torch.zeros(4)}, {}, 0.0,
                             scales, epochs=50, tol=-1e18, patience=10_000,
                             check_every=16)
    np.testing.assert_allclose(ens.mu, scales, rtol=1e-6)
    assert np.all(np.abs(ens.final_params["w"].numpy() - scales) < 0.01)


def test_fit_ensemble_budget_fidelity():
    """Exactly `epochs` steps per run with a tail chunk (7 = 4 + 3)."""
    ens = tloop.fit_ensemble(_counting_loss, _SGD(1.0), {"w": torch.zeros(3)}, {}, 0.0,
                             1.0, epochs=7, tol=-1e18, patience=10_000, check_every=4)
    np.testing.assert_allclose(ens.final_params["w"].numpy(), -7.0)
    assert ens.loss_history.shape == (3, 7)


def test_fit_ensemble_per_run_batch():
    """tests/test_trainers.py: per_run_batch replicating the shared base
    reproduces the shared-batch run exactly; a per-run-scaled base changes
    only that run."""
    _, tspec, _, tb = _batches(SMALL)
    runs = _t(_np_params(SMALL["layers"], 1, R=2))
    loss_fn = tprob.make_loss_fn(tspec)
    opt = make_optimizer("adam", 1e-3, clip_norm=1.0)
    kw = dict(epochs=60, tol=0.0, patience=10 ** 9, check_every=60)
    ref = tloop.fit_ensemble(loss_fn, opt, runs, tb, 0.0, 0.01, **kw)
    keys = ("base_val", "base_grad", "base_lap", "base_bval")
    same = tloop.fit_ensemble(loss_fn, opt, runs, tb, 0.0, 0.01,
                              per_run_batch={k: torch.stack([tb[k]] * 2) for k in keys},
                              **kw)
    np.testing.assert_array_equal(same.loss_history, ref.loss_history)
    diff = tloop.fit_ensemble(loss_fn, opt, runs, tb, 0.0, 0.01,
                              per_run_batch={k: torch.stack([tb[k], 1.02 * tb[k]])
                                             for k in keys}, **kw)
    np.testing.assert_array_equal(diff.loss_history[0], ref.loss_history[0])
    assert not np.allclose(diff.loss_history[1], ref.loss_history[1])


# ---- the per-run optimizer -------------------------------------------------

def _optimizers(lr_mode):
    """(optax chain with extra-args support, the port's single-run form)."""
    if lr_mode == "make_optimizer":
        from gpe_tpu.train.optimizers import make_optimizer as jmake
        from gpe_tpu.train.schedules import cosine_warm_restarts as jcwr
        pair = (jmake("adam", jcwr(1e-3, 200, 2, 1e-6), clip_norm=1.0),
                make_optimizer("adam", cosine_warm_restarts(1e-3, 200, 2, 1e-6),
                               clip_norm=1.0))
    else:
        pair = jpl.ramp_optimizer(1e-3, lr_mode), tpl.ramp_optimizer(1e-3, lr_mode)
    return optax.with_extra_args_support(pair[0]), pair[1]


@pytest.mark.parametrize("lr_mode", LR_MODES + ("make_optimizer",))
def test_per_run_optimizer_matches_vmapped_optax(lr_mode):
    """Two updates of three runs, run 0's gradient below the clip norm and
    the others above, each run with its own loss: the port's per-run form
    against jax.vmap of the optax chain."""
    jopt, topt = _optimizers(lr_mode)
    topt = topt.per_run_form()
    f = np.array([1e-3, 3.0, 40.0], np.float32)
    grads = [(w * f[:, None, None], b * f[:, None] + 0.1)
             for w, b in _np_params(TINY["layers"], 11, R=3)]
    params = _np_params(TINY["layers"], 12, R=3)
    jp, jg = _j(params), _j(grads)
    jst = jax.vmap(jopt.init)(jp)
    tst = topt.init(_t(params))
    upd = jax.vmap(lambda g, s, p, v: jopt.update(g, s, p, value=v))
    for value in (np.array([0.5, 150.0, 3e-3], np.float32),
                  np.array([420.0, 0.2, 7.0], np.float32)):
        ju, jst = upd(jg, jst, jp, jnp.asarray(value))
        tu, tst = topt.update(_t(grads), tst, torch.as_tensor(value))
        for (tw, tb), (jw, jb) in zip(tu, ju):
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("lr_mode", LR_MODES)
def test_per_run_optimizer_keeps_runs_apart(lr_mode):
    """Scaling one run's gradient by 100 leaves every other run's update
    unchanged, bit for bit: the clip and the loss-as-step LR are per run."""
    topt = tpl.ramp_optimizer(1e-3, lr_mode).per_run_form()
    grads = _t(_np_params(TINY["layers"], 13, R=3))
    loud = torch.tensor([1.0, 100.0, 1.0])
    louder = tuple((w * loud[:, None, None], b * loud[:, None]) for w, b in grads)
    value = torch.tensor([0.3, 2.0, 50.0])
    single = tpl.ramp_optimizer(1e-3, lr_mode)
    st = [topt.init(grads), topt.init(grads), single.init(grads), single.init(grads)]
    coupled = False
    for f in (1.0, 0.25):               # two steps, the state carried
        g0 = tuple((w * f, b * f) for w, b in grads)
        g1 = tuple((w * f, b * f) for w, b in louder)
        u0, st[0] = topt.update(g0, st[0], value)
        u1, st[1] = topt.update(g1, st[1], value)
        for (w0, b0), (w1, b1) in zip(u0, u1):
            for r in (0, 2):
                assert torch.equal(w0[r], w1[r]) and torch.equal(b0[r], b1[r])
        # the single-run form couples the runs through one global norm
        s0, st[2] = single.update(g0, st[2], value[0])
        s1, st[3] = single.update(g1, st[3], value[0])
        coupled = coupled or not torch.equal(s0[0][0][0], s1[0][0][0])
    assert coupled


# ---- pretraining through the hard-BC factor --------------------------------

def test_pretrain_apply_fn_adam_phase_matches_jax():
    """pretrain_to_base(apply_fn=net × sine factor), Adam only (no L-BFGS),
    60 steps on the box: params and final MSE against JAX's."""
    kw = dict(TINY, **BOX)
    jspec, tspec, jb, tb = _batches(kw)
    init = _np_params(TINY["layers"], 14)
    from gpe_tpu.models.ansatz import box_sine_factor as jfactor
    jf, tf = jfactor(0.0, 1.0), box_sine_factor(0.0, 1.0)
    japply = lambda p, x, act: jmlp.mlp_apply(p, x, act) * jf(x).value
    tapply = lambda p, x, act: mlp_apply(p, x, act) * tf(x).value
    target = np.asarray(jprob.base_triple(jspec, 1, jb["x"]).value)
    jp, jmse = jpre.pretrain_to_base(_j(init), jb["x"], target, jspec.activation,
                                     epochs=60, lbfgs_steps=0, apply_fn=japply)
    tp, tmse = pretrain_to_base(_t(init), tb["x"], torch.as_tensor(target),
                                tspec.activation, epochs=60, lbfgs_steps=0,
                                apply_fn=tapply)
    for (tw, tbb), (jw, jbb) in zip(tp, jp):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tbb.numpy(), np.asarray(jbb), rtol=1e-5, atol=1e-7)
    # the MSE of the complete solution at the start of the last step, as
    # JAX reports it (losses[-1] of its scan)
    np.testing.assert_allclose(tmse, float(jmse), rtol=1e-5)


# ---- the compare functions -------------------------------------------------

def test_vanilla_checkpoints_matches_single_model():
    """tests/test_trainers.py: the batched vanilla column (one ensemble over
    per-run γ) runs train_single_model(use_perturbation=False)'s protocol.
    The batched and the single GEMMs round differently (7.7e-7 in the first
    loss), and SMALL's direct-net trajectories amplify that chaotically (to
    7.2e-3 in μ at γ = 1.5 after 300 epochs), so the protocol is held over
    the first 20 epochs at 1e-5, and 300 epochs to the γ = 0 eigenvalue."""
    spec = tprob.GPESpec(**SMALL)
    gs = [0.0, 1.5]
    kw = dict(tol=0.0, patience=10 ** 9, pretrain_epochs=300, check_every=150,
              device="cpu")
    batched = tcompare.train_vanilla_checkpoints(spec, gs, mode=0, epochs=20, **kw)
    for g in gs:
        seq = tcompare.train_single_model(spec, g, 0, use_perturbation=False,
                                          epochs=20, **kw)
        np.testing.assert_allclose(batched[g], seq.mu, rtol=1e-5)
    full = tcompare.train_vanilla_checkpoints(spec, gs, mode=0, epochs=300, **kw)
    assert abs(full[0.0] - 1.0) < 5e-2 and full[1.5] > full[0.0]


def _carry_inits(monkeypatch, direct):
    """Both packages start seed s from numpy params of seed s; with
    direct=True both pretrain by Adam alone (no L-BFGS phase)."""
    monkeypatch.setattr(jcompare.mlp, "init_mlp",
                        lambda key, lay, scheme="xavier_uniform":
                        _j(_np_params(lay, int(np.asarray(key)[-1]))))
    monkeypatch.setattr(tcompare, "_init",
                        lambda spec, seed, dev: _t(_np_params(spec.layers, seed)))
    if direct:
        for mod in (jcompare, tcompare):
            fn = mod.pretrain_to_base
            monkeypatch.setattr(mod, "pretrain_to_base",
                                lambda *a, fn=fn, **k: fn(*a, **dict(k, lbfgs_steps=0)))


CMP_RUN = dict(epochs=30, tol=0.0, patience=10 ** 9, pretrain_epochs=30, check_every=15)


@pytest.mark.parametrize("case", ["single_pl", "single_vanilla_box", "vanilla_checkpoints",
                                  "curriculum", "multiple_runs"])
def test_compare_functions_match_jax(case, monkeypatch):
    """Each compare function end to end from the same initial params, TINY:
    μ within 3e-3 relative of the JAX package's. The PL-PINN cases keep
    the L-BFGS pretraining (the gap it opens, ROADMAP Queue 3, stays under
    3e-3 through the q-scaled ansatz). A direct net's μ carries its
    pretraining error at full strength, and the two L-BFGS phases put the
    vanilla and curriculum μ 3.8e-2 apart here; those cases pretrain by Adam
    alone on both sides."""
    direct = case != "single_pl" and case != "multiple_runs"
    _carry_inits(monkeypatch, direct)
    kw = dict(TINY, **BOX) if case.endswith("box") else dict(TINY)
    jspec, tspec = jprob.GPESpec(**kw), tprob.GPESpec(**kw)
    if case.startswith("single"):
        pl = case == "single_pl"
        j = [jcompare.train_single_model(jspec, 2.0, 0, use_perturbation=pl, **CMP_RUN).mu]
        t = [tcompare.train_single_model(tspec, 2.0, 0, use_perturbation=pl,
                                         device="cpu", **CMP_RUN).mu]
    elif case == "vanilla_checkpoints":
        jd = jcompare.train_vanilla_checkpoints(jspec, [0.0, 2.0], 1, **CMP_RUN)
        td = tcompare.train_vanilla_checkpoints(tspec, [0.0, 2.0], 1, device="cpu",
                                                **CMP_RUN)
        assert list(td) == list(jd)
        j, t = list(jd.values()), list(td.values())
    elif case == "curriculum":
        jd = jcompare.train_curriculum_ramp(jspec, [0.0, -2.0], 0, **CMP_RUN)
        td = tcompare.train_curriculum_ramp(tspec, [0.0, -2.0], 0, device="cpu",
                                            **CMP_RUN)
        assert list(td) == list(jd) == [0.0, -2.0]
        j, t = list(jd.values()), list(td.values())
    else:
        kw_runs = dict(CMP_RUN, n_runs=3, success_threshold=1e-3)
        jd = jcompare.train_multiple_runs(jspec, 2.0, **kw_runs)
        td = tcompare.train_multiple_runs(tspec, 2.0, device="cpu", **kw_runs)
        assert td["seeds"] == jd["seeds"] == [42, 43, 44]
        np.testing.assert_array_equal(td["success_mask"], jd["success_mask"])
        assert td["loss_median"].shape == jd["loss_median"].shape
        j = list(jd["mu_runs"]) + [jd["mu_median"]]
        t = list(td["mu_runs"]) + [td["mu_median"]]
    assert all(math.isfinite(v) for v in t)
    np.testing.assert_allclose(t, j, rtol=3e-3)


def test_compare_methods_reports_errors():
    spec = tprob.GPESpec(**TINY)
    out = tcompare.compare_methods(spec, 0.0, mu_ref=1.0, device="cpu",
                                   **dict(CMP_RUN, epochs=5, pretrain_epochs=5))
    assert list(out) == ["pl_pinn", "vanilla"]
    for d in out.values():
        assert set(d) == {"mu", "best_loss", "epochs", "loss_history", "abs_error",
                          "rel_error"}
        assert d["abs_error"] == abs(d["mu"] - 1.0)


# ---- the tables ------------------------------------------------------------

@pytest.mark.parametrize("family,mode,gammas", [
    ("p3_harmonic", 0, (0.0, 20.0, 100.0)), ("p3_harmonic", 3, (0.0, 20.0, 100.0)),
    ("p3_gravity_well", 0, (0.0, 100.0)), ("p3_gravity_well", 5, (0.0, 100.0))])
def test_oracle_mu_equals_the_committed_tables(family, mode, gammas):
    """_oracle_mu meets the committed raw CSVs' float64 mu_ref (V from the
    f32 grid, as the JAX package computes it)."""
    spec = tpt.family(family)["spec"]
    ref = tss._oracle_from_csv(ROOT / "runs" / f"comparison_results_{family}")
    got = tpt._oracle_mu(spec, mode, gammas, device="cpu")
    for g in gammas:
        assert abs(got[g] - ref[(mode, g)]) <= 1e-14, (g, got[g], ref[(mode, g)])


def test_write_error_table_is_byte_equal_to_jax(tmp_path):
    from gpe_tpu.utils.metrics import write_error_table as jwrite
    from gpe_tpu_torch.utils.metrics import MetricsLogger, write_error_table
    rows = [{"mode": "Mode 0", "method": "PL-PINN", "mu": 1.0000123, "mu_ref": 1.0,
             "gamma": 0.0},
            {"mode": "Mode 1", "method": "Vanilla PINN", "mu": 7.25, "mu_ref": 7.3,
             "gamma": 20.0, "note": "x_y"},
            {"mode": "Mode 1", "method": "Curriculum Training", "gamma": 40.0}]
    for side, fn in (("jax", jwrite), ("torch", write_error_table)):
        fn(rows, str(tmp_path / side), stem="t")
    for ext in ("csv", "tex"):
        assert (tmp_path / "torch" / f"t.{ext}").read_bytes() == \
            (tmp_path / "jax" / f"t.{ext}").read_bytes()
    log = MetricsLogger("r")
    log.log(0, loss=1.5, mu=2)
    log.log(512, loss=0.5)
    log.to_csv(str(tmp_path / "m.csv"))
    log.to_jsonl(str(tmp_path / "m.jsonl"))
    assert (tmp_path / "m.csv").read_text().splitlines()[0] == "step,loss,mu,wall_s"
    last = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])
    assert last["step"] == 512 and last["loss"] == 0.5 and "mu" not in last


def _tiny_family(monkeypatch, name="p3_harmonic", **spec_kw):
    fam = dict(tpt._families()[name])
    fam["spec"] = replace(fam["spec"], **dict(TINY, **spec_kw))
    monkeypatch.setattr(tpt, "_families", lambda: {name: fam})
    monkeypatch.setattr(tcompare, "pretrain_to_base", _short(tcompare.pretrain_to_base))
    monkeypatch.setattr(tpl, "pretrain_to_base", _short(tpl.pretrain_to_base))
    return fam


def _short(fn):
    return lambda *a, **k: fn(*a, **dict(k, epochs=5, lbfgs_steps=2))


def _short_lm(monkeypatch):
    """The LM polishes cut to 2 steps of 5 CG iterations."""
    from gpe_tpu_torch.train import gauss_newton
    make = gauss_newton.make_lm_solver
    monkeypatch.setattr(gauss_newton, "make_lm_solver",
                        lambda *a, **k: make(*a, **dict(k, steps=2, cg_iters=5)))


def test_run_family_writes_the_jax_file_set(tmp_path, monkeypatch):
    """run_family at tiny depth (mode 0, a 3-rung ramp, 4 epochs): JAX's
    files and columns, every method's row at every checkpoint, the oracle
    rows equal to _oracle_mu; then modes_filter merges and only_baselines
    reuses the PL columns."""
    fam = _tiny_family(monkeypatch)
    fam["checkpoints"] = (0.0, 20.0)
    _short_lm(monkeypatch)
    out = tmp_path / "tables"
    kw = dict(epochs=4, ramp_step=10.0, modes_filter=(0,), verbose=False, device="cpu")
    summary = tpt.run_family("p3_harmonic", str(out), **kw)
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["raw_comparison_results.csv", "paper_style_results.csv",
         "comparison_table.csv", "comparison_table.tex", "summary.json"])
    with open(out / "raw_comparison_results.csv", newline="") as f:
        raw = list(csv.DictReader(f))
    assert list(raw[0]) == ["Method", "Mode", "Gamma", "mu", "mu_ref", "Abs Error",
                            "Rel Error"]
    assert [(r["Gamma"], r["Method"]) for r in raw] == [
        (g, m) for g in ("0.0", "20.0") for m in tpt.METHOD_ORDER]
    ref = tpt._oracle_mu(fam["spec"], 0, (0.0, 20.0), device="cpu")
    assert all(float(r["mu_ref"]) == ref[float(r["Gamma"])] for r in raw)
    with open(out / "paper_style_results.csv", newline="") as f:
        paper = list(csv.DictReader(f))
    assert list(paper[0]) == ["Mode", "Method", "abs_err", "rel_err_pct"]
    assert [r["Method"] for r in paper] == list(tpt.METHOD_ORDER)
    assert set(json.loads((out / "summary.json").read_text())) == {"rows", "summary"}
    assert summary["family"] == "p3_harmonic"
    assert "Mode 0" in summary["pl_pinn_mean_abs_err"]
    assert set(summary["seconds"]) == set(tpt.METHOD_ORDER) - {"PL-PINN-R+LM"}
    pl = {r["Gamma"]: r["mu"] for r in raw if r["Method"] == "PL-PINN"}
    tpt.run_family("p3_harmonic", str(out), only_baselines=True, **kw)
    with open(out / "raw_comparison_results.csv", newline="") as f:
        again = list(csv.DictReader(f))
    assert {r["Gamma"]: r["mu"] for r in again if r["Method"] == "PL-PINN"} == pl
    assert len(again) == len(raw)


def _tiny_config(monkeypatch, name):
    cfg = EXPERIMENTS[name]
    monkeypatch.setitem(EXPERIMENTS, name, replace(cfg, spec=replace(cfg.spec, **TINY)))
    monkeypatch.setattr(tcompare, "pretrain_to_base", _short(tcompare.pretrain_to_base))


@pytest.mark.parametrize("name", ["compare_harmonic_mode0", "multirun_harmonic_mode0",
                                  "multirun_box_mode0"])
def test_run_main_compare_branch_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    """The runner's compare branch at tiny depth: the JAX record's keys
    (plus `seconds`), multirun_stats.json keyed and shaped as the JAX
    runner writes it, and summary.json."""
    _tiny_config(monkeypatch, name)
    assert run.main([name, "--cpu", "--epochs", "4", "--out", str(tmp_path)]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()
             if s.startswith("{")]
    cfg = EXPERIMENTS[name]
    if cfg.n_runs > 1:
        (rec,) = lines
        assert set(rec) == {"pl_pinn", "vanilla", "seconds"}
        stats = json.loads((tmp_path / name / "multirun_stats.json").read_text())
        assert list(stats) == ["pl_pinn", "vanilla"]
        for m, v in stats.items():
            assert set(v) == {"mu_median", "mu_std", "mu_runs", "epochs_run"}
            assert len(v["mu_runs"]) == 5 and all(1 <= e <= 4 for e in v["epochs_run"])
            assert rec[m] == {"mu_median": v["mu_median"], "mu_std": v["mu_std"]}
        if name == "multirun_box_mode0":
            assert abs(stats["pl_pinn"]["mu_median"] - math.pi ** 2) < 1e-2
    else:
        assert [r["gamma"] for r in lines] == list(cfg.gamma_values)
        for r in lines:
            assert set(r) == {"gamma", "pl_pinn", "vanilla", "seconds"}
            assert set(r["pl_pinn"]) == {"mu", "loss"}
    summary = json.loads((tmp_path / name / "summary.json").read_text())
    assert summary == (lines if len(lines) != 1 else lines[0])


# ---- the hard-BC seed ensemble ---------------------------------------------

@pytest.mark.parametrize("rebase", [False, True])
def test_train_seeds_vmapped_matches_a_per_seed_loop(rebase, monkeypatch):
    """The box seed ensemble as one fit_ensemble against train_plpinn seed
    by seed (the same seeds, pretraining, ramp and rebase generators)."""
    monkeypatch.setattr(tpl, "pretrain_to_base", _short(tpl.pretrain_to_base))
    import gpe_tpu_torch.train.pretrain as tpre
    monkeypatch.setattr(tpre, "pretrain_to_base", _short(tpre.pretrain_to_base))
    spec = tprob.GPESpec(**dict(TINY, **BOX))
    ramp = [0.0, 1.0, 2.0]
    got = tss._train_seeds_vmapped(spec, ramp, 0, 2, 42, 6, 10 ** 9, "loss_faithful",
                                   rebase, check_every=4, device="cpu")
    assert list(got) == ramp
    for i in range(2):
        one = tpl.train_plpinn(spec, ramp, modes=(0,), epochs=6, tol=0.0,
                               patience=10 ** 9, seed=42 + 1000 * i, check_every=4,
                               pretrain_epochs=2000, rebase=rebase, device="cpu")
        np.testing.assert_allclose([got[g][i] for g in ramp],
                                   [m for _, m in one.mu_table[0]], rtol=1e-5)
