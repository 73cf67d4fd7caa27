"""Port parity of the packed-ensemble slice: `kernels/packing.py`, the run
mode of K1/K2 (K3), the run-mode value-and-grad, `packed_ramp_optimizer`,
`fit_ensemble_packed`, `train_plpinn_modes_packed` and the seed-statistics
entry, against the JAX package on the CPU.

The JAX side runs its lane-packed kernels in interpret mode on
`pack_params` of the same runs; the port keeps the runs stacked on a run
axis and takes the kernels' plain versions for CPU tensors. Inputs come from
numpy seeds. Tolerances are those of tests/test_torch_kernels.py (f32 on
both sides, other summation orders): rtol 2e-5 on loss values, 1e-5 on the
gradient path's total and μ, normalised atol 2e-4 on gradients.
"""
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.pallas import packing as jpack  # noqa: E402
from gpe_tpu.pallas.fused_grad import make_pallas_value_and_grad  # noqa: E402
from gpe_tpu.pallas.fused_residual import make_pallas_loss_eval  # noqa: E402
from gpe_tpu.train import packed as jpacked  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.kernels import fused_grad as k2  # noqa: E402
from gpe_tpu_torch.kernels import fused_residual as k1  # noqa: E402
from gpe_tpu_torch.kernels import packing as tpack  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import packed as tpacked  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

SPEC = dict(n_points=256, lb=-8.0, ub=8.0, potential="harmonic", basis="hermite",
            p=3.0, nonlinearity="power", activation="shifted_tanh")
TILE = 128                              # JAX interpret-mode tile (divides 256)
W64, W32 = (1, 64, 64, 1), (1, 32, 32, 1)


def _np_runs(layers, R, seed):
    """Run-stacked numpy params: leaves (R, fan_in, fan_out) and (R, fan_out)."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(0.0, 1.0 / np.sqrt(k), (R, k, m)).astype(np.float32),
             rng.normal(0.0, 0.1, (R, m)).astype(np.float32))
            for k, m in zip(layers[:-1], layers[1:])]


def _j(tree):
    return tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in tree)


def _case(layers, modes, per_run, seed=0):
    """(jspec, tspec, numpy run params, shared numpy batch, per-run numpy
    bases (R, n)/(R, B) of `modes` or None, γ (R,), scale (R,))."""
    jspec = jprob.GPESpec(layers=layers, **SPEC)
    tspec = tprob.GPESpec(layers=layers, **SPEC)
    batch = {k: np.asarray(v) for k, v in jprob.make_batch(jspec, modes[0]).items()}
    R = len(modes)
    bases = None
    if per_run:
        bases = {"base_val": [], "base_lap": [], "base_bval": []}
        for m in modes:
            bm = jprob.make_batch(jspec, m)
            for k in bases:
                bases[k].append(np.asarray(bm[k]))
        bases = {k: np.stack(v) for k, v in bases.items()}
    gammas = np.linspace(0.5, 2.0, R).astype(np.float32)
    scales = (0.01 * (1.0 + np.arange(R))).astype(np.float32)
    return jspec, tspec, _np_runs(layers, R, seed), batch, bases, gammas, scales


def _jax_unit_batch(batch, bases, M, u=0):
    """JAX's packed batch of unit u: per-run bases as (n, M) columns."""
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    if bases is not None:
        for k, v in bases.items():
            b[k] = jnp.asarray(v[u * M:(u + 1) * M].T)
    return b


def _torch_batch(batch, bases):
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    if bases is not None:
        b.update({k: torch.as_tensor(v) for k, v in bases.items()})
    return b


def _phys(spec):
    return (spec.layers, spec.activation, spec.p, spec.kinetic, spec.nonlinearity)


def _grads_close(got, want, atol=2e-4):
    for li, ((gw, gb), (ww, wb)) in enumerate(zip(got, want)):
        for a, b, what in ((gw, ww, "W"), (gb, wb, "b")):
            a, b = np.asarray(a), np.asarray(b)
            for r in range(b.shape[0]):
                s = np.max(np.abs(b[r])) + 1e-12
                np.testing.assert_allclose(a[r] / s, b[r] / s, atol=atol,
                                           err_msg=f"{what} grad layer {li} run {r}")


# ---- packing.py host functions ---------------------------------------------

@pytest.mark.parametrize("layers,M,R", [(W64, 2, 4), (W32, 4, 4), ((2, 32, 32, 32, 1), 2, 6)])
def test_packing_host_functions_match_jax(layers, M, R):
    runs = _np_runs(layers, R, seed=3)
    jp = jpack.pack_params(_j(runs), M)
    tp = tpack.pack_params(params_from_numpy(runs, device="cpu"), M)
    for (jw, jb), (tw, tb) in zip(jp, tp):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for (w, b), (w0, b0) in zip(tpack.unpack_params(tp, layers, M), runs):
        np.testing.assert_array_equal(w.numpy(), w0)
        np.testing.assert_array_equal(b.numpy(), b0)
    for (jw, jb), (tw, tb) in zip(jpack.block_masks(layers, M),
                                  tpack.block_masks(layers, M, device="cpu")):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    masks = tpack.block_masks(layers, M, device="cpu")
    jmasked = jpack.mask_grads(jp, jpack.block_masks(layers, M))
    for (jw, jb), (tw, tb) in zip(jmasked, tpack.mask_grads(tp, masks)):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    old = jpack.pack_params(_j(_np_runs(layers, R, seed=4)), M)
    cond = np.random.default_rng(5).random((R // M, M)) < 0.5
    jsel = jpack.run_where(None, jnp.asarray(cond), jp, old)
    tsel = tpack.run_where(None, torch.as_tensor(cond), tp,
                           tuple((torch.as_tensor(np.asarray(w)),
                                  torch.as_tensor(np.asarray(b))) for w, b in old))
    for (jw, jb), (tw, tb) in zip(jsel, tsel):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tpack.packed_layers(layers, M) == jpack.packed_layers(layers, M)


@pytest.mark.parametrize("layers", [W64, W32, (1, 64, 32, 1), (2, 100, 100, 1),
                                    (1, 16, 16, 16, 1), (1, 64, 2)])
def test_packable_runs_and_pick_m_match_jax(layers):
    assert tpack.packable_runs(layers) == jpack.packable_runs(layers)
    for n in (1, 2, 3, 4, 5, 6, 7, 8, 12):
        assert tpacked._pick_m(layers, n) == jpacked._pick_m(layers, n), (layers, n)


# ---- the run mode of K1 and K2 ----------------------------------------------

EVAL_CASES = {
    "M2_per_run_odd_modes": (W64, (1, 3), True),
    "M2_shared_base": (W64, (0, 0), False),
    "M4_per_run_modes_0to3": (W32, (0, 1, 2, 3), True),
}


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_plain_run_k1_matches_jax_packed_eval(name):
    layers, modes, per_run = EVAL_CASES[name]
    jspec, tspec, runs, batch, bases, gammas, scales = _case(layers, modes, per_run)
    M = len(modes)
    ev = make_pallas_loss_eval(*_phys(jspec), bc_weight=jspec.bc_weight,
                               norm_weight=jspec.norm_weight, tile=TILE,
                               interpret=True, n_runs=M)
    p_u = jax.tree.map(lambda a: a[0], jpack.pack_params(_j(runs), M))
    jt, jaux = ev(p_u, _jax_unit_batch(batch, bases, M), jnp.asarray(gammas),
                  jnp.asarray(scales))
    t_ev = k1.make_loss_eval(*_phys(tspec), bc_weight=tspec.bc_weight,
                             norm_weight=tspec.norm_weight, runs=True)
    tt, taux = t_ev(params_from_numpy(runs, device="cpu"), _torch_batch(batch, bases),
                    torch.as_tensor(gammas), torch.as_tensor(scales))
    assert tt.shape == (M,) and taux["mu"].shape == (M,)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2e-5)
    np.testing.assert_allclose(taux["mu"].numpy(), np.asarray(jaux["mu"]), rtol=2e-5)
    np.testing.assert_allclose(taux["boundary"].numpy(), np.asarray(jaux["boundary"]),
                               rtol=2e-5, atol=1e-9)
    # each run's sums are its own single-run sums
    tb = _torch_batch(batch, bases)
    sums = k1.collocation_sums_runs(
        params_from_numpy(runs, device="cpu"), tb["x"], tb["V"], tb["w"],
        torch.as_tensor(gammas), torch.as_tensor(scales), tb["base_val"],
        tb["base_lap"], tspec.activation, tspec.p, tspec.kinetic, tspec.nonlinearity)
    for r in range(M):
        one = k1.collocation_sums(
            params_from_numpy([(w[r], b[r]) for w, b in runs], device="cpu"),
            tb["x"], tb["V"], tb["w"], float(gammas[r]), float(scales[r]),
            tb["base_val"][r] if per_run else tb["base_val"],
            tb["base_lap"][r] if per_run else tb["base_lap"], tspec.activation,
            tspec.p, tspec.kinetic, tspec.nonlinearity)
        torch.testing.assert_close(sums[r], one, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["M2_per_run_odd_modes", "M4_per_run_modes_0to3"])
def test_plain_run_exact_vag_matches_jax_packed_vag(name):
    layers, modes, per_run = EVAL_CASES[name]
    jspec, tspec, runs, batch, bases, gammas, scales = _case(layers, modes, per_run, 1)
    M = len(modes)
    vagM = make_pallas_value_and_grad(*_phys(jspec), bc_weight=jspec.bc_weight,
                                      norm_weight=jspec.norm_weight, tile=TILE,
                                      sum_tile=TILE, interpret=True, n_runs=M)
    p_u = jax.tree.map(lambda a: a[0], jpack.pack_params(_j(runs), M))
    (jt, jaux), jg = vagM(p_u, _jax_unit_batch(batch, bases, M), jnp.asarray(gammas),
                          jnp.asarray(scales))
    jg_runs = jpack.unpack_params(jax.tree.map(lambda a: a[None], jg), layers, M)
    vag = k2.make_value_and_grad(*_phys(tspec), bc_weight=tspec.bc_weight,
                                 norm_weight=tspec.norm_weight, runs=True)
    (tt, taux), tg = vag(params_from_numpy(runs, device="cpu"), _torch_batch(batch, bases),
                         torch.as_tensor(gammas), torch.as_tensor(scales))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5)
    np.testing.assert_allclose(taux["mu"].numpy(), np.asarray(jaux["mu"]), rtol=1e-5)
    _grads_close(tg, jg_runs)


def test_plain_run_vag_matches_two_jax_units_under_vmap():
    """R = 4 width-64 runs (modes 0–3, per-run bases) are U = 2 JAX packed
    units of M = 2, advanced by jax.vmap over the unit axis."""
    layers, modes, M = W64, (0, 1, 2, 3), 2
    jspec, tspec, runs, batch, bases, gammas, scales = _case(layers, modes, True, 2)
    U = len(modes) // M
    vagM = make_pallas_value_and_grad(*_phys(jspec), bc_weight=jspec.bc_weight,
                                      norm_weight=jspec.norm_weight, tile=TILE,
                                      sum_tile=TILE, interpret=True, n_runs=M)
    shared = {k: jnp.asarray(v) for k, v in batch.items() if k not in bases}
    ub = {k: jnp.asarray(v.reshape(U, M, -1).transpose(0, 2, 1)) for k, v in bases.items()}
    (jt, jaux), jg = jax.vmap(lambda p, u, g, s: vagM(p, dict(shared, **u), g, s))(
        jpack.pack_params(_j(runs), M), ub, jnp.asarray(gammas).reshape(U, M),
        jnp.asarray(scales).reshape(U, M))
    vag = k2.make_value_and_grad(*_phys(tspec), bc_weight=tspec.bc_weight,
                                 norm_weight=tspec.norm_weight, runs=True)
    (tt, taux), tg = vag(params_from_numpy(runs, device="cpu"), _torch_batch(batch, bases),
                         torch.as_tensor(gammas), torch.as_tensor(scales))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt).reshape(-1), rtol=1e-5)
    np.testing.assert_allclose(taux["mu"].numpy(), np.asarray(jaux["mu"]).reshape(-1),
                               rtol=1e-5)
    _grads_close(tg, jpack.unpack_params(jg, layers, M))


def test_plain_run_relaxed_vag_matches_jax_over_steps():
    """delayed + fresh_values + extrapolate, threaded over 3 steps from the
    same param sequence on both sides (the updates come from JAX's grads)."""
    layers, modes = W32, (0, 1, 2, 3)
    jspec, tspec, runs, batch, bases, gammas, scales = _case(layers, modes, True, 3)
    M = len(modes)
    kw = dict(delayed=True, fresh_values=True, extrapolate=True)
    vagM = make_pallas_value_and_grad(*_phys(jspec), bc_weight=jspec.bc_weight,
                                      norm_weight=jspec.norm_weight, tile=TILE,
                                      sum_tile=TILE, interpret=True, n_runs=M, **kw)
    vag = k2.make_value_and_grad(*_phys(tspec), bc_weight=tspec.bc_weight,
                                 norm_weight=tspec.norm_weight, runs=True, **kw)
    jb, tb = _jax_unit_batch(batch, bases, M), _torch_batch(batch, bases)
    jg_, js_ = jnp.asarray(gammas), jnp.asarray(scales)
    tg_, ts_ = torch.as_tensor(gammas), torch.as_tensor(scales)
    p_u = jax.tree.map(lambda a: a[0], jpack.pack_params(_j(runs), M))
    tparams = params_from_numpy(runs, device="cpu")
    jst = vagM.init_state(p_u, jb, jg_, js_)
    tst = vag.init_state(tparams, tb, tg_, ts_)
    for step in range(3):
        (jt, jaux), jg, jst = vagM(p_u, jb, jg_, js_, jst)
        (tt, taux), tg, tst = vag(tparams, tb, tg_, ts_, tst)
        # the loss-value bound (2e-5): the sums agree to ~1e-7, but a small
        # pde = (S₀ − 2μS₁ + μ²S₂)/N cancels digits (1.9e-5 on one run here)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2e-5)
        np.testing.assert_allclose(taux["mu"].numpy(), np.asarray(jaux["mu"]), rtol=1e-5)
        _grads_close(tg, jpack.unpack_params(jax.tree.map(lambda a: a[None], jg),
                                             layers, M))
        np.testing.assert_allclose(tst[0].numpy(), np.asarray(jst[0]).T, rtol=2e-5)
        assert tst[2] == int(jst[2]) == step + 1
        p_u = jax.tree.map(lambda p, d: p - 3e-3 * d, p_u, jg)
        tparams = tuple((torch.as_tensor(np.asarray(w)), torch.as_tensor(np.asarray(b)))
                        for w, b in jpack.unpack_params(
                            jax.tree.map(lambda a: a[None], p_u), layers, M))


# ---- the optimizer and the ensemble trainer ---------------------------------

@pytest.mark.parametrize("lr_mode", ["loss_faithful", "cosine", "constant"])
def test_packed_ramp_optimizer_matches_jax(lr_mode):
    """Two updates on the same run-stacked (port) / packed (JAX) gradients:
    per-run clip (one run's norm below the clip, the others above), Adam,
    the per-run LR."""
    layers, M = W32, 4
    rng = np.random.default_rng(7)
    f = np.array([1e-3, 1.0, 3.0, 10.0], np.float32)        # per-run grad scale
    grads = [(w * f[:, None, None], b * f[:, None])
             for w, b in _np_runs(layers, M, seed=8)]
    params = _np_runs(layers, M, seed=9)
    losses = [np.array([0.5, 3.0, 150.0, 1e-3], np.float32),
              rng.uniform(0.0, 400.0, M).astype(np.float32)]
    jopt = jpacked.packed_ramp_optimizer(1e-3, lr_mode, M)
    topt = tpacked.packed_ramp_optimizer(1e-3, lr_mode)
    jp = jax.tree.map(lambda a: a[0], jpack.pack_params(_j(params), M))
    jg = jax.tree.map(lambda a: a[0], jpack.pack_params(_j(grads), M))
    tp, tg = params_from_numpy(params, device="cpu"), params_from_numpy(grads, device="cpu")
    jst, tst = jopt.init(jp), topt.init(tp)
    for value in losses:
        ju, jst = jopt.update(jg, jst, jp, value=jnp.asarray(value))
        tu, tst = topt.update(tg, tst, torch.as_tensor(value))
        ju_runs = jpack.unpack_params(jax.tree.map(lambda a: a[None], ju), layers, M)
        # f32, a few roundings in another order (the per-run norms sum the
        # packed zeros too)
        for (tw, tb), (jw, jb) in zip(tu, ju_runs):
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-12)
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-12)


@functools.lru_cache(maxsize=1)
def _fit_case():
    return _case(W32, (0, 1, 2, 3), True, 4)


def _fit_kw(tol, epochs):
    return dict(epochs=epochs, tol=tol, patience=10 ** 9, check_every=8, lr=1e-3,
                lr_mode="loss_faithful")


def _fit_jax(tol, epochs=20):
    jspec, _, runs, batch, bases, gammas, scales = _fit_case()
    return jpacked.fit_ensemble_packed(
        jspec, _j(runs), {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(gammas), jnp.asarray(scales), per_run_base=bases,
        interpret=True, **_fit_kw(tol, epochs))


def _fit_torch(tol, epochs=20):
    _, tspec, runs, batch, bases, gammas, scales = _fit_case()
    return tpacked.fit_ensemble_packed(
        tspec, params_from_numpy(runs, device="cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()},
        torch.as_tensor(gammas), torch.as_tensor(scales), per_run_base=bases,
        **_fit_kw(tol, epochs))


def test_fit_ensemble_packed_matches_jax_with_an_early_stop():
    """20 steps (chunks of 8), four runs with their own bases, γ and scale;
    tol set so that one run stops early and the others run on: the
    histories, the stop epochs, the best losses and μ at the restored params
    follow JAX's; the stopped run's params stay bit-frozen."""
    h = _fit_jax(tol=-1.0).loss_history
    a = int(np.argmin(h[:, :10].min(axis=1)))
    others = min(h[r].min() for r in range(h.shape[0]) if r != a)
    assert h[a, :10].min() < others                 # the seeded inputs allow it
    tol = float(0.5 * (h[a, :10].min() + others))
    jres, tres = _fit_jax(tol), _fit_torch(tol)
    assert int(jres.epochs_run[a]) < 10
    np.testing.assert_array_equal(tres.epochs_run, jres.epochs_run)
    assert sorted(set(tres.epochs_run.tolist())) == sorted({int(jres.epochs_run[a]), 20})
    # f32 trajectories with other summation orders: the JAX package's own
    # packed-vs-vmapped bounds (tests/test_packing.py)
    np.testing.assert_allclose(tres.loss_history, jres.loss_history, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(tres.mu_history, jres.mu_history, rtol=1e-4)
    np.testing.assert_allclose(tres.best_loss, jres.best_loss, rtol=1e-4)
    np.testing.assert_allclose(tres.mu_best, jres.mu_best, rtol=1e-4)
    # frozen: the stopped run's last params are the same after 20 and 12 steps
    short = _fit_torch(tol, epochs=12)
    for (w20, b20), (w12, b12) in zip(tres.final_params, short.final_params):
        assert torch.equal(w20[a], w12[a]) and torch.equal(b20[a], b12[a])
        assert not torch.equal(w20[(a + 1) % 4], w12[(a + 1) % 4])


def test_train_plpinn_modes_packed_reduced():
    """Modes 0 and 1 plus a second seed of mode 1, two γ, rebase: μ(γ=0)
    recovers the exact 2n+1 and μ rises with γ. The inits differ from JAX's
    (torch.Generator vs JAX PRNG), so the bound is set against the exact
    eigenvalue: the pretrained base is the exact eigenfunction, so a larger
    error means a broken path, not an under-trained one."""
    spec = tprob.GPESpec(n_points=256, layers=W32, activation="tanh")
    res = tpacked.train_plpinn_modes_packed(
        spec, [1.0, 0.0], modes=(0, 1, 1), epochs=200, tol=1e-6, patience=10 ** 9,
        pretrain_epochs=300, check_every=100, lr_mode="cosine", rebase=True,
        device="cpu")
    m0 = dict(res.mu_table[0])
    assert abs(m0[0.0] - 1.0) < 1e-2 and m0[1.0] > m0[0.0], m0
    flat = res.mu_table[1]                 # two seeds of mode 1, in ramp order
    assert [g for g, _ in flat] == [0.0, 0.0, 1.0, 1.0]
    for (g, mu) in flat:
        assert abs(mu - 3.0) < 1e-2 if g == 0.0 else mu > 3.0, flat
    assert flat[0][1] != flat[1][1]                  # independent seeds
    assert set(res.epochs_history[0].values()) == {200}


# ---- the CPU/CUDA contract, the gates and the experiment entry ---------------

def test_cpu_tensors_take_the_plain_run_versions():
    layers, modes = W32, (0, 3)
    _, tspec, runs, batch, bases, gammas, scales = _case(layers, modes, True, 5)
    tb = _torch_batch(batch, bases)
    tparams = params_from_numpy(runs, device="cpu")
    k1.collocation_sums_runs.launches = 0
    k2.collocation_grads_runs.launches = 0
    args = (tparams, tb["x"], tb["V"], tb["w"], torch.as_tensor(gammas),
            torch.as_tensor(scales))
    base = (tb["base_val"], tb["base_lap"])
    phys = (tspec.activation, tspec.p, tspec.kinetic, tspec.nonlinearity)
    got = k1.collocation_sums_runs(*args, *base, *phys)
    assert torch.equal(got, k1.collocation_sums_runs_plain(*args, *base, *phys))
    cots = torch.tensor([[1e-3, -2e-3, 1e-3, 0.5], [2e-3, -1e-3, 3e-3, -0.2]])
    grads, sums = k2.collocation_grads_runs(*args, cots, *base, *phys)
    pgrads, psums = k2.collocation_grads_runs_plain(*args, cots, *base, *phys)
    assert torch.equal(sums, psums) and torch.equal(sums, got)
    for a, b in zip(grads, pgrads):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert k1.collocation_sums_runs.launches == 0
    assert k2.collocation_grads_runs.launches == 0


def test_packed_gates_follow_jax(monkeypatch):
    monkeypatch.delenv("GPE_TPU_TORCH_NO_FUSED", raising=False)
    monkeypatch.delenv("GPE_TPU_TORCH_NO_PACKED", raising=False)
    paper = dict(n_points=4000, lb=-10.0, ub=10.0, potential="harmonic",
                 basis="hermite", p=3.0, nonlinearity="power",
                 activation="shifted_tanh")
    for layers, n in (((1, 64, 64, 64, 1), 6), ((1, 64, 64, 64, 1), 5),
                      (W32, 4), ((1, 64, 32, 1), 4)):
        jspec = jprob.GPESpec(layers=layers, **paper)
        tspec = tprob.GPESpec(layers=layers, **paper)
        M = tpacked._pick_m(layers, n)
        assert M == jpacked._pick_m(layers, n)
        # off the accelerator both sides decline the packed path
        assert tpacked.packed_runs_available(tspec, n, device="cpu") is None
        assert jpacked.packed_runs_available(jspec, n) is None
        assert tprob.make_packed_value_and_grad(tspec, max(M, 2), device="cpu") is None
        # JAX's own eligibility (its interpret mode skips the TPU gate)
        want = M >= 2 and jprob.make_packed_value_and_grad(
            jspec, M, interpret=True) is not None
        assert (M >= 2 and tprob.packed_eligible(tspec, M)) == want, (layers, n)
    hard = tprob.GPESpec(layers=W32, hard_bc=True)
    assert not tprob.packed_eligible(hard, 4)


def test_paper_families_configs_and_oracle_match_jax():
    from gpe_tpu.experiments import paper_tables as jpt
    from gpe_tpu.experiments import seed_stats as jss
    from gpe_tpu_torch.experiments import paper_tables as tpt
    from gpe_tpu_torch.experiments import seed_stats as tss
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS

    assert tpt.CHECKPOINTS == jpt.CHECKPOINTS
    jf = jpt._families()
    for name, fam in tpt._families().items():
        for k in ("modes", "checkpoints", "gamma_step"):
            assert fam.get(k) == jf[name].get(k), (name, k)
        for f in ("lb", "ub", "n_points", "dim", "layers", "activation", "potential",
                  "basis", "p", "kinetic", "nonlinearity", "bc_weight",
                  "norm_weight", "hard_bc"):
            assert getattr(fam["spec"], f) == getattr(jf[name]["spec"], f), (name, f)
    for name in set(jf) - set(tpt._families()):
        with pytest.raises(NotImplementedError, match="waits for"):
            tpt.family(name)
    assert EXPERIMENTS["harmonic_paper"].spec == tpt.family("p3_harmonic")["spec"]
    d = tss.REPO / "runs" / "comparison_results_p3_harmonic"
    ref = tss._oracle_from_csv(d)
    assert ref == jss._oracle_from_csv(str(d))
    assert all(abs(ref[(n, 0.0)] - (2 * n + 1)) < 1e-6 for n in range(6))
    # the hard-BC seed ensemble (the packed kernels cannot take it) trains
    # on fit_ensemble: μ of every seed at every γ of the ramp
    box = tprob.GPESpec(n_points=96, layers=(1, 8, 8, 1), lb=0.0, ub=1.0,
                        potential="box", basis="box", hard_bc=True)
    mus = tss._train_seeds_vmapped(box, [0.0, 1.0], 0, 2, 42, 3, 10 ** 9,
                                   "loss_faithful", True, device="cpu")
    assert list(mus) == [0.0, 1.0]
    assert all(len(v) == 2 and all(np.isfinite(v)) for v in mus.values())
    assert all(abs(m - np.pi ** 2) < 0.5 for m in mus[0.0])


def test_seed_stats_cli_runs_the_packed_branch_on_the_cpu(tmp_path, monkeypatch):
    """The CLI end to end on a reduced p3_harmonic family (small net and grid,
    two seeds, a 3-rung ramp): the per-seed μ table of the run-stacked
    ensemble, scored against the committed oracle."""
    import json

    from gpe_tpu_torch.experiments import seed_stats as tss

    fam = dict(tss.get_family("p3_harmonic"),
               spec=tprob.GPESpec(n_points=128, layers=(1, 16, 16, 1), **{
                   k: v for k, v in SPEC.items() if k != "n_points"}))
    monkeypatch.setattr(tss, "get_family", lambda name: fam)
    out = tmp_path / "stats.json"
    assert tss.main(["--family", "p3_harmonic", "--modes", "0", "--n-seeds", "2",
                     "--epochs", "5", "--ramp-step", "50", "--device", "cpu",
                     "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["seeds"] == [42, 1042] and res["protocol"]["checkpoints"] == [0.0, 100.0]
    for method in ("PL-PINN", "PL-PINN-R"):
        rows = res["modes"]["0"][method]["rows"]
        assert [r["gamma"] for r in rows] == [0.0, 100.0]
        assert all(len(r["mu_seeds"]) == 2 for r in rows)
        assert abs(rows[0]["mu_seeds"][0] - 1.0) < 1e-2     # γ=0: the exact base
        assert rows[1]["mu_seeds"][0] > 1.0                    # repulsive γ raises μ
