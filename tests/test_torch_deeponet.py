"""Port parity of the physics-informed DeepONet (`gpe_tpu_torch/deeponet/`)
and of the runner's `deeponet` branch against the JAX package on the CPU
(small sizes).

Tolerances: the family batches bit-equal (numpy draws them on both sides,
both cast to f32); apply/vgl in f32 at rtol 1e-4 / atol 1e-5 of the
largest value (other GEMM summation orders; the Laplacian's small entries
read 6.6e-5 relative apart); the loss and its gradients in
float64 (JAX under x64) at rtol 1e-10 and normalised atol 1e-9 (in f32 the
pde term's cancellation leaves 2.3e-5 in the first branch layer's
gradient); a short train_deeponet from carried-over params: loss histories
at rtol 1e-4 and μ per potential at rtol 1e-5 (f32 Adam trajectories,
measured 7e-7 and 2e-6); the held-out FDM oracle μ at 1e-10 (scipy on the
host on both sides), predicted μ and ψ errors at rtol 1e-5.
"""
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.deeponet import model as jd  # noqa: E402
from gpe_tpu.validate.fdm import solve_gpe_excited_1d as j_fdm  # noqa: E402
from gpe_tpu_torch.deeponet import model as td  # noqa: E402
from gpe_tpu_torch.experiments import run  # noqa: E402
from gpe_tpu_torch.train.loop import value_and_grad  # noqa: E402

SMALL = dict(branch_layers=(16, 16, 8), trunk_layers=(1, 16, 8), n_sensors=16, n_points=64)
# the keys of the JAX runner's deeponet record (gpe_tpu/experiments/run.py:409-421)
JAX_RECORD = {"experiment", "gamma", "train_mu_range", "heldout", "interp_max_mu_err",
              "interp_max_psi_l2", "extrap_max_mu_err", "wall_s"}


def _setup(seed=0, n_functions=4, **kw):
    spec_kw = dict(SMALL, **kw)
    js, ts = jd.DeepONetSpec(**spec_kw), td.DeepONetSpec(**spec_kw)
    nparams = jax.tree.map(np.asarray, jd.init_deeponet(jax.random.PRNGKey(seed), js))
    jb = jd.make_potential_family_batch(js, n_functions, seed=3)
    tb = td.make_potential_family_batch(ts, n_functions, seed=3, device="cpu")
    return js, ts, nparams, jb, tb


def _jtree(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def test_params_carry_and_init_shapes():
    js, ts, nparams, _, _ = _setup()
    tp = td.deeponet_params_from_numpy(nparams, device="cpu")
    assert tp["bias"].shape == () and tp["bias"].dtype == torch.float32
    own = td.init_deeponet(ts, torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(jax.tree.leaves(nparams), torch.utils._pytree.tree_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), a)
    assert [t.shape for t in torch.utils._pytree.tree_leaves(own)] == \
        [t.shape for t in torch.utils._pytree.tree_leaves(tp)]
    with pytest.raises(ValueError, match="branch, trunk, bias"):
        td.deeponet_params_from_numpy({"branch": nparams["branch"]}, device="cpu")


@pytest.mark.parametrize("family", ["scaled_harmonic", "shifted_gaussian"])
def test_family_batch_matches_jax(family):
    js, ts, _, _, _ = _setup()
    jb = jd.make_potential_family_batch(js, 5, family, seed=7)
    tb = td.make_potential_family_batch(ts, 5, family, seed=7, device="cpu")
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    pinned = td.make_potential_family_batch(ts, 2, betas=[0.45, 2.1], device="cpu")
    jpinned = jd.make_potential_family_batch(js, 2, betas=[0.45, 2.1])
    np.testing.assert_array_equal(pinned["V"].numpy(), np.asarray(jpinned["V"]))


def test_apply_and_vgl_match_jax():
    js, ts, nparams, jb, tb = _setup()
    jp, tp = _jtree(nparams, jnp.float32), td.deeponet_params_from_numpy(nparams, device="cpu")
    ju = jd.deeponet_apply(jp, jb["v_sensors"], jb["x"])
    jv, jl = jd.deeponet_vgl(jp, jb["v_sensors"], jb["x"])
    tu = td.deeponet_apply(tp, tb["v_sensors"], tb["x"])
    tv, tl = td.deeponet_vgl(tp, tb["v_sensors"], tb["x"])
    assert tu.shape == (4, 64) and tl.shape == (4, 64)
    for got, want in ((tu, ju), (tv, jv), (tl, jl)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_loss_and_grads_match_jax_f64():
    js, ts, nparams, jb, tb = _setup()
    with jax.enable_x64(True):
        jp = _jtree(nparams, jnp.float64)
        jb64 = _jtree(jb, jnp.float64)
        (jt, ja), jg = jax.value_and_grad(jd.make_deeponet_loss(js), has_aux=True)(
            jp, jb64, jnp.float64(1.0), jnp.float64(1.0))
        jg = [np.asarray(g) for g in jax.tree.leaves(jg)]
        ja = {k: np.asarray(v) for k, v in ja.items()}
        jt = float(jt)
    tp = td.deeponet_params_from_numpy(nparams, device="cpu", dtype=torch.float64)
    tb64 = {k: v.double() for k, v in tb.items()}
    one = torch.tensor(1.0, dtype=torch.float64)
    (tt, ta), tg = value_and_grad(td.make_deeponet_loss(ts))(tp, tb64, one, one)
    np.testing.assert_allclose(float(tt), jt, rtol=1e-10)
    for k in ("pde", "boundary", "norm", "mu", "mu_per_fn", "total"):
        np.testing.assert_allclose(ta[k].numpy(), ja[k], rtol=1e-10, err_msg=k)
    for got, want in zip(torch.utils._pytree.tree_leaves(tg), jg):
        s = np.abs(want).max() + 1e-30
        np.testing.assert_allclose(got.numpy() / s, want / s, rtol=0, atol=1e-9)


def test_analytic_targets_match_jax():
    js, ts, _, jb, tb = _setup()
    np.testing.assert_allclose(td._analytic_family_targets(tb).numpy(),
                               np.asarray(jd._analytic_family_targets(jb)),
                               rtol=1e-6, atol=1e-7)


def test_train_and_evaluate_match_jax_from_carried_params(monkeypatch):
    """train_deeponet (30 pretraining steps, 20 fit epochs at γ = 1) from
    JAX's initial params on both sides, then the held-out evaluation."""
    js, ts, nparams, _, _ = _setup()
    kw = dict(gamma=1.0, epochs=20, n_functions=4, pretrain_epochs=30, check_every=10)
    jr = jd.train_deeponet(js, **kw)
    monkeypatch.setattr(td, "init_deeponet", lambda spec, gen, dev:
                        td.deeponet_params_from_numpy(nparams, device=dev))
    tr = td.train_deeponet(ts, device="cpu", **kw)
    assert tr.loss_history.shape == (20,)
    np.testing.assert_allclose(tr.loss_history, np.asarray(jr.loss_history), rtol=1e-4)
    np.testing.assert_allclose(tr.mu_per_fn, np.asarray(jr.mu_per_fn), rtol=1e-5)
    betas = [0.8, 1.5]
    jrows, ju, jx = jd.evaluate_deeponet(js, jr.params, betas, 1.0)
    trows, tu, tx = td.evaluate_deeponet(ts, tr.params, betas, 1.0)
    assert tu.shape == ju.shape and tx.shape == jx.shape
    np.testing.assert_array_equal(tx, jx)
    for t, j in zip(trows, jrows):
        assert set(t) == set(j) and t["beta"] == j["beta"]
        np.testing.assert_allclose(t["mu_ref"], j["mu_ref"], rtol=0, atol=1e-10)
        for k in ("mu_pred", "mu_abs_err", "psi_l2_err"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)


def test_runner_deeponet_branch_on_the_cpu(tmp_path, capsys):
    """deeponet_harmonic through the runner at full width, 5 + 5 steps: the
    JAX record's keys (plus seconds and the plot, drawn from the saved
    held-out arrays), the nine held-out β, and the FDM oracle μ of JAX's
    on the same grid."""
    assert run.main(["deeponet_harmonic", "--cpu", "--train", "--epochs", "5",
                     "--pretrain", "5", "--out", str(tmp_path)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == JAX_RECORD | {"seconds", "plot"}
    assert set(rec["seconds"]) == {"train", "heldout"}
    assert rec["plot"] == ["deeponet_heldout.png"]
    assert [r["beta"] for r in rec["heldout"]] == run.DEEPONET_TEST_BETAS
    assert rec["gamma"] == 1.0 and rec["extrap_max_mu_err"] is not None
    assert json.loads((tmp_path / "deeponet_harmonic" / "summary.json").read_text()) == rec
    assert sorted(p.name for p in (tmp_path / "deeponet_harmonic").glob("deeponet_heldout.*")) \
        == ["deeponet_heldout.npz", "deeponet_heldout.png"]
    spec = jd.DeepONetSpec(p=3.0)
    x = np.asarray(jd.make_potential_family_batch(spec, 1, betas=[1.0])["x"][:, 0],
                   np.float64)
    for r in rec["heldout"][::4]:
        want, _ = j_fdm(r["beta"] * x ** 2, x[1] - x[0], 1.0, 0, kinetic=spec.kinetic,
                        p=spec.p, nonlinearity=spec.nonlinearity)
        np.testing.assert_allclose(r["mu_ref"], want, rtol=0, atol=1e-10)
