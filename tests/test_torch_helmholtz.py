"""Port parity of the Helmholtz family (`gpe_tpu_torch/helmholtz/`), of
`make_lm_solver` on any params tree, of `fit_hybrid`, of the siren init and
of the runner's `helmholtz` and `optimizer_sweep` branches, against the JAX
package on the CPU (small sizes).

Tolerances: the collocation points bit-equal (numpy's RNG draws them on
both sides) and the disk's Bessel data too (scipy on the host); the
square's exact values (torch's sin against XLA's) at 1e-6; loss, aux,
residual and gradient at rtol 1e-6 in f32 and 1e-10 in f64 (gradients
normalised by the largest entry of each leaf); the pair-tree LM bit-equal
to its flat-vector form, the inverse-k LM against JAX's in f64 at
LM_RTOL; fit_hybrid's Adam phase at loss rtol 1e-4 (tests/test_torch_train.py's
f32 trajectory bound) and its L-BFGS losses at 1e-3.
"""
import json
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.helmholtz import problem as jh  # noqa: E402
from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.train import gauss_newton as jgn  # noqa: E402
from gpe_tpu.train import hybrid as jhybrid  # noqa: E402
from gpe_tpu_torch.experiments import run  # noqa: E402
from gpe_tpu_torch.experiments.configs import EXPERIMENTS, helmholtz_specs  # noqa: E402
from gpe_tpu_torch.helmholtz import problem as th  # noqa: E402
from gpe_tpu_torch.models import mlp as tmlp  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import gauss_newton as tgn  # noqa: E402
from gpe_tpu_torch.train import hybrid as thybrid  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

SMALL = dict(layers=(2, 16, 16, 1), n_interior=128, n_boundary=16)
# the inverse-k LM in f64: 30 CG iterations on JᵀJ + λ·curv·I, stopped
# before convergence, amplify the two packages' other summation orders
# (also with θ laid out in JAX's sorted-key order) to 2.4e-6 in the first
# step's loss and 5e-8 in k after six steps
LM_RTOL = 1e-5
KINDS = {
    "square": dict(domain="square", k=2.0),
    "circle": dict(domain="circle", k=3.0, mode_n=1),
    "inverse_k": dict(domain="square", k=3.0, learnable_k=True, learnable_bc_scale=True),
}


def _specs(kind, **extra):
    kw = {**KINDS[kind], **SMALL, **extra}
    return jh.HelmholtzSpec(**kw), th.HelmholtzSpec(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree, dtype=torch.float32):
    return params_from_numpy(_np(tree), device="cpu", dtype=dtype)


def _flat(tree):
    """Leaves by key name for dicts (the two packages order dict leaves
    differently), in order for the net's pairs."""
    if isinstance(tree, dict):
        return {k: _flat(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [np.asarray(t) for pair in tree for t in pair]
    return [np.asarray(tree)]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batches_match_jax(kind):
    jspec, tspec = _specs(kind)
    jb, tb = jh.make_helmholtz_batch(jspec, 3), th.make_helmholtz_batch(tspec, 3, device="cpu")
    assert set(jb) == set(tb)
    for k in jb:
        assert tb[k].dtype == torch.float32 and tb[k].shape == jb[k].shape, k
        if k.startswith("bx") or k == "x" or jspec.domain == "circle":
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
        else:
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_exact_solutions_match_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-1.0, 1.0, (64, 2)).astype(np.float32)
    for kind in ("square", "circle"):
        jspec, tspec = _specs(kind)
        want = np.asarray(jh.square_exact(jspec, jnp.asarray(xy)) if kind == "square"
                          else jh.circle_exact(jspec, xy))
        got = (th.square_exact(tspec, torch.as_tensor(xy)).numpy() if kind == "square"
               else th.circle_exact(tspec, xy))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _params(jspec, seed=1):
    return jh.init_helmholtz_params(jspec, seed)


def _grads_t(loss_fn, params, batch, k):
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    total, aux = loss_fn(torch.utils._pytree.tree_unflatten(leaves, spec), batch, k,
                         torch.tensor(1.0, dtype=k.dtype))
    g = torch.autograd.grad(total, leaves)
    return total, aux, torch.utils._pytree.tree_unflatten(list(g), spec)


def _assert_grads(tg, jg, rtol):
    tg = _flat(torch.utils._pytree.tree_map(lambda t: t.numpy(), tg))
    jg = _flat(jg)
    assert set(tg) == set(jg)
    for key in jg:
        for a, b in zip(tg[key], jg[key]):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(), err_msg=key)


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_loss_residual_and_grads_match_jax(kind, f64):
    """Total, aux, the residual vector and the gradient of every leaf (k and
    bc_scale too) on the same params and batch."""
    rtol = 1e-10 if f64 else 1e-6
    jdt = jnp.float64 if f64 else jnp.float32
    tdt = torch.float64 if f64 else torch.float32
    jspec, tspec = _specs(kind)
    with jax.enable_x64(f64):
        batch = {k: np.asarray(v, jdt) for k, v in jh.make_helmholtz_batch(jspec, 0).items()}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), _params(jspec))
        k = jnp.asarray(jspec.k, jdt)
        jloss = jh.make_helmholtz_loss(jspec)
        (jtotal, jaux), jg = jax.jit(jax.value_and_grad(
            lambda p: jloss(p, jb, k, jnp.asarray(1.0, jdt)), has_aux=True))(jp)
        jr = np.asarray(jax.jit(jh.make_helmholtz_residual_fn(jspec))(
            jp, jb, k, jnp.asarray(1.0, jdt)))
        jaux, jg = _np(jaux), _np(jg)
    tb = {key: torch.as_tensor(v) for key, v in batch.items()}
    tp = _t(_params(jspec), tdt)
    tk = torch.tensor(jspec.k, dtype=tdt)
    total, aux, tg = _grads_t(th.make_helmholtz_loss(tspec), tp, tb, tk)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=rtol)
    for key in ("pde", "boundary", "data", "k", "mu", "total"):
        np.testing.assert_allclose(float(aux[key].detach()), float(jaux[key]), rtol=rtol,
                                   atol=1e-30, err_msg=key)
    _assert_grads(tg, jg, rtol)
    tr = th.make_helmholtz_residual_fn(tspec)(tp, tb, tk, torch.tensor(1.0, dtype=tdt))
    np.testing.assert_allclose(tr.numpy(), jr, rtol=rtol, atol=rtol * np.abs(jr).max())
    if tspec.learnable_bc_scale:
        # the weight ascends: its gradient is −MSE_bc on both sides
        assert float(tg["bc_scale"]) < 0 and float(jg["bc_scale"]) < 0
        np.testing.assert_allclose(float(tg["bc_scale"]), -float(aux["boundary"]), rtol=rtol)
    if not tspec.learnable_k:
        # the fixed-weight residual's sum of squares is the training loss
        np.testing.assert_allclose(float(torch.sum(tr * tr)), float(total), rtol=1e-5)


def test_lm_solver_takes_any_tree_and_keeps_the_pair_bits():
    """make_lm_solver on (W, b) pairs equals, bit for bit, the solver over
    one flat vector whose residual splits it into pairs as the solver did
    before it took any tree; on Helmholtz's inverse-k dict (0-d k and
    bc_scale) it matches JAX's make_lm_solver in f64 at LM_RTOL, k refined
    jointly with the net."""
    spec = tprob.GPESpec(n_points=64, layers=(1, 8, 8, 1))
    batch = tgn.to_f64(tprob.make_batch(spec, 0, device="cpu"))
    res_fn = tgn.make_gpe_residual_fn(spec)
    rng = np.random.default_rng(5)
    pairs = tuple((torch.tensor(rng.uniform(-0.5, 0.5, (i, o))),
                   torch.tensor(rng.uniform(-0.1, 0.1, (o,))))
                  for i, o in zip(spec.layers[:-1], spec.layers[1:]))
    shapes = [t.shape for pair in pairs for t in pair]
    sizes = [int(np.prod(s)) for s in shapes]

    def old_unravel(theta):
        leaves = [c.view(s) for c, s in zip(torch.split(theta, sizes), shapes)]
        return tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))

    theta0 = torch.cat([t.reshape(-1) for pair in pairs for t in pair])
    gamma, scale = 1.0, 0.1
    new = tgn.make_lm_solver(res_fn, pairs, steps=4, cg_iters=10)(pairs, batch, gamma, scale)
    old = tgn.make_lm_solver(lambda th_, *a: res_fn(old_unravel(th_), *a), theta0,
                             steps=4, cg_iters=10)(theta0, batch, gamma, scale)
    assert np.array_equal(new.loss_history, old.loss_history)
    assert torch.equal(torch.cat([t.reshape(-1) for p in new.params for t in p]), old.params)
    assert isinstance(new.params, tuple) and all(isinstance(p, tuple) for p in new.params)

    jspec, tspec = _specs("inverse_k")
    with jax.enable_x64(True):
        hb = {k: np.asarray(v, np.float64) for k, v in jh.make_helmholtz_batch(jspec, 0).items()}
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _params(jspec))
        jp["k_raw"] = jnp.float64(2.7)
        jlm = jgn.make_lm_solver(jh.make_helmholtz_residual_fn(jspec), jp, steps=6,
                                 cg_iters=30)
        jres = jlm(jp, {k: jnp.asarray(v) for k, v in hb.items()}, 3.0, 1.0)
        jk, jl = float(jres.params["k_raw"]), np.asarray(jres.loss_history)
        jnet = _flat(_np(jres.params))["net"]
    tp = _t(_params(jspec), torch.float64)
    tp["k_raw"] = torch.tensor(2.7, dtype=torch.float64)
    tlm = tgn.make_lm_solver(th.make_helmholtz_residual_fn(tspec), tp, steps=6, cg_iters=30)
    tres = tlm(tp, {k: torch.as_tensor(v) for k, v in hb.items()},
               torch.tensor(3.0, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64))
    assert set(tres.params) == {"net", "k_raw", "bc_scale"} and tres.params["k_raw"].ndim == 0
    assert abs(jk - 2.7) > 1e-3                    # k moved with the net
    np.testing.assert_allclose(float(tres.params["k_raw"]), jk, rtol=LM_RTOL)
    np.testing.assert_allclose(tres.loss_history, jl, rtol=LM_RTOL)
    for a, b in zip(_flat({"net": tres.params["net"]})["net"], jnet):
        np.testing.assert_allclose(a, b, rtol=LM_RTOL, atol=LM_RTOL * np.abs(b).max())
    assert float(tres.params["bc_scale"]) == 10.0


def test_fit_hybrid_matches_jax():
    """Adam 30 epochs then 5 L-BFGS steps on the small square problem from
    the same params and batch."""
    jspec, tspec = _specs("square")
    jb = jh.make_helmholtz_batch(jspec, 0)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in jb.items()}
    jp = _params(jspec)
    jr = jhybrid.fit_hybrid(jh.make_helmholtz_loss(jspec), jp, jb, jspec.k, 1.0,
                            adam_epochs=30, lbfgs_steps=5, clip_norm=1.0, check_every=10)
    tr = thybrid.fit_hybrid(th.make_helmholtz_loss(tspec), _t(jp), tb, tspec.k, 1.0,
                            adam_epochs=30, lbfgs_steps=5, clip_norm=1.0, check_every=10)
    np.testing.assert_allclose(tr.adam.loss_history, np.asarray(jr.adam.loss_history),
                               rtol=1e-4)
    np.testing.assert_allclose(tr.lbfgs_losses, np.asarray(jr.lbfgs_losses), rtol=1e-3)
    assert tr.lbfgs_losses[-1] < tr.lbfgs_losses[0]
    assert set(tr.seconds) == {"adam", "lbfgs"}
    np.testing.assert_allclose(tr.mu, jr.mu)                 # μ is k here


@pytest.mark.parametrize("kind", ["square", "inverse_k"])
def test_train_helmholtz_matches_jax(kind, monkeypatch):
    """train_helmholtz with its Adam → L-BFGS → LM chain at a tiny size, the
    port started from JAX's params (monkeypatched init): test MAE, interior
    MSE and k at rtol 1e-2, the LM polish lowering the MAE of the hybrid."""
    jspec, tspec = _specs(kind)
    kw = dict(epochs=40, check_every=20, lbfgs_steps=3, lm_steps=3, lm_cg_iters=10)
    jr = jh.train_helmholtz(jspec, **kw)
    monkeypatch.setattr(th, "init_helmholtz_params",
                        lambda spec, seed=0, device=None: _t(jh.init_helmholtz_params(jspec, seed)))
    tr = th.train_helmholtz(tspec, device="cpu", **kw)
    for f in ("test_mae", "interior_mse", "k", "k_error"):
        np.testing.assert_allclose(getattr(tr, f), getattr(jr, f), rtol=1e-2, atol=1e-6,
                                   err_msg=f)
    assert set(tr.seconds) == {"adam", "lbfgs", "lm"}
    without = th.train_helmholtz(tspec, device="cpu", **{**kw, "lm_steps": 0})
    assert tr.test_mae < without.test_mae


def test_siren_init_draws_within_jax_limits():
    """init_mlp("siren", w0=): the JAX draw's shapes and limits — first layer
    U(−w0/fan_in, w0/fan_in), hidden U(−√(6/fan_in), √(6/fan_in)), bias 0 —
    and JAX's siren weights carried across unchanged."""
    layers, w0 = (2, 48, 48, 1), 6.0
    jp = jmlp.init_mlp(jax.random.PRNGKey(0), layers, scheme="siren", w0=w0)
    tp = tmlp.init_mlp(layers, "siren", w0=w0, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    for li, ((tw, tb), (jw, jb)) in enumerate(zip(tp, jp)):
        lim = w0 / layers[li] if li == 0 else math.sqrt(6.0 / layers[li])
        assert tw.shape == jw.shape and tb.shape == jb.shape
        for w in (tw.numpy(), np.asarray(jw)):
            assert np.abs(w).max() <= lim and np.abs(w).max() > 0.8 * lim
        assert not tb.any() and not np.asarray(jb).any()
    carried = params_from_numpy(_np(jp), device="cpu")
    for (cw, _), (jw, _) in zip(carried, jp):
        np.testing.assert_array_equal(cw.numpy(), np.asarray(jw))
    spec = th.HelmholtzSpec(init_scheme="siren", activation="sin", w0=3.0, **SMALL)
    net = th.init_helmholtz_params(spec, device="cpu")["net"]
    assert float(net[0][0].abs().max()) <= 3.0 / 2


def test_runner_helmholtz_and_optimizer_sweep_branches(tmp_path, monkeypatch, capsys):
    """The two new branches at a tiny size: helmholtz_inverse_k (JAX record's
    keys, seconds of each phase) and the optimizer sweep cut to two
    optimizers, two η and a [1,12,12,1] net."""
    from dataclasses import replace

    import gpe_tpu_torch.experiments.configs as cfgs

    small = {n: replace(s, layers=(2, 12, 12, 1), n_interior=96, n_boundary=12)
             for n, s in helmholtz_specs().items()}
    monkeypatch.setattr(cfgs, "helmholtz_specs", lambda: small)
    assert run.main(["helmholtz_inverse_k", "--cpu", "--train", "--epochs", "10",
                     "--lbfgs-steps", "2", "--lm-steps", "2", "--out", str(tmp_path)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"experiment", "k", "test_mae", "interior_mse", "k_error", "wall_s",
                        "seconds"}
    assert set(rec["seconds"]) == {"adam", "lbfgs", "lm"}
    assert math.isfinite(rec["test_mae"]) and abs(rec["k"] - 3.0) == pytest.approx(rec["k_error"])

    cfg = EXPERIMENTS["different_optimizers_harmonic"]
    monkeypatch.setitem(EXPERIMENTS, "different_optimizers_harmonic", replace(
        cfg, spec=replace(cfg.spec, n_points=128, layers=(1, 12, 12, 1)),
        optimizers=("adahessian", "shampoo")))
    assert run.main(["different_optimizers_harmonic", "--cpu", "--train", "--epochs", "4",
                     "--gammas", "0", "10", "--out", str(tmp_path)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
             if x.startswith("{")]
    assert [r["optimizer"] for r in lines] == ["adahessian", "shampoo"]
    for r in lines:
        assert set(r) == {"optimizer", "mu_table", "ms_per_step", "seconds", "plot"}
        assert r["plot"] == ["optimizer_comparison.png"]
        assert [e for e, _ in r["mu_table"]] == [0.0, 10.0]
        assert all(math.isfinite(m) for _, m in r["mu_table"]) and r["ms_per_step"] > 0
    summary = json.loads((tmp_path / "different_optimizers_harmonic" / "summary.json").read_text())
    assert [r["optimizer"] for r in summary] == ["adahessian", "shampoo"]
