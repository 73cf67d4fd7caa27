"""Port parity of the optimizer zoo (`gpe_tpu_torch/train/optimizers.py`,
`shampoo.py`, `lbfgs.py`) against the JAX package's `make_optimizer` and
optax on the CPU, and the JAX package's own optimizer tests
(tests/test_optimizers.py) ported.

Every name of `make_optimizer`, and adam with `plateau`, takes 25 updates
on a [1,16,16,1] params tree with synthetic gradients and losses (L-BFGS
the objective's own, which its line search evaluates), clip_norm 1.0:
float64 at rtol 1e-9 where optax runs under x64; float32 at rtol 1e-5 for
adam (ClipAdam's f32 count) and the JAX package's own transforms (qhadam,
adahessian, ranger21), which compute their bias corrections in f32.
Ranger21's update on a lookahead sync step is slow − params, a
difference of param-sized numbers, so one f32 ulp of the params is its
floor. AdaHessian and Sophia take the Hutchinson probes JAX draws from its keys
(`rademacher_like` monkeypatched to hand them over). L-BFGS against
optax.lbfgs (value and gradient reused from the line search's state) on
the Rosenbrock function and a small GPE loss, float64, 20 steps.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.train import hybrid as jhybrid  # noqa: E402
from gpe_tpu.train import optimizers as jopt  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.models import mlp as tmlp  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import hybrid as thybrid  # noqa: E402
from gpe_tpu_torch.train import lbfgs as tlbfgs  # noqa: E402
from gpe_tpu_torch.train import optimizers as topt  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402
from gpe_tpu_torch.train.loop import fit  # noqa: E402

LAYERS = (1, 16, 16, 1)
STEPS = 25
LR = 1e-3
# (name, kwargs, float64?)
CASES = [
    ("adam", {}, False),
    ("adamw", {}, True),
    ("qhadam", {}, False),
    ("adahessian", {}, False),
    ("adabelief", {}, True),
    ("sophia", {}, True),
    ("rmsprop", {}, True),
    ("sgd", {}, True),
    ("muon", {}, True),
    ("prodigy", {}, True),
    ("ranger21", {}, False),
    ("shampoo", {"precondition_frequency": 5}, True),   # five eigh refreshes
    ("distributed_shampoo", {}, True),
    ("lbfgs", {}, True),
    ("plateau", {"plateau": {"patience": 3}}, True),     # adam + reduce-on-plateau
]


def _np_params(layers, seed):
    rng = np.random.default_rng(seed)
    return tuple((rng.uniform(-0.5, 0.5, (i, o)), rng.uniform(-0.1, 0.1, (o,)))
                 for i, o in zip(layers[:-1], layers[1:]))


def _data(n=24, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, (n, 1))
    return x, np.sin(2.0 * x[:, 0])


def _leaves(tree):
    return [np.asarray(t) for pair in tree for t in pair]


def _assert_tree(got, want, rtol, floor=None):
    """Each leaf at rtol, normalised by the leaf's largest entry (or by
    `floor`'s matching leaf where that is larger)."""
    floor = _leaves(floor) if floor is not None else [0.0] * len(_leaves(want))
    for g, w, f in zip(_leaves(tuple(tuple(t.numpy() for t in p) for p in got)),
                       _leaves(want), floor):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=max(rtol * np.abs(w).max(), np.max(f), 1e-30))


@pytest.mark.parametrize("name,kw,f64", CASES, ids=[c[0] for c in CASES])
def test_every_optimizer_matches_jax(name, kw, f64, monkeypatch):
    dtype = np.float64 if f64 else np.float32
    tdtype = torch.float64 if f64 else torch.float32
    rtol = 1e-9 if f64 else 1e-5
    opt_name = "adam" if name == "plateau" else name
    rng = np.random.default_rng(7)
    x, y = _data()
    p0 = _np_params(LAYERS, 1)
    probes = []

    def handed_probes(leaves, generator):
        return [torch.as_tensor(np.asarray(z), dtype=t.dtype) for z, t in
                zip(probes.pop(0), leaves)]

    monkeypatch.setattr(topt, "rademacher_like", handed_probes)
    tx = torch.as_tensor(x, dtype=tdtype)
    ty = torch.as_tensor(y, dtype=tdtype)
    tobj = lambda p: torch.mean((tmlp.mlp_apply(p, tx, "tanh") - ty) ** 2)
    gen = torch.Generator().manual_seed(0)
    with jax.enable_x64(f64):
        jx, jy = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
        jobj = lambda p: jnp.mean((jmlp.mlp_apply(p, jx, "tanh") - jy) ** 2)
        jo = optax.with_extra_args_support(jopt.make_optimizer(opt_name, LR, clip_norm=1.0, **kw))
        to = topt.make_optimizer(opt_name, LR, clip_norm=1.0, **kw)
        jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p0)
        tp = params_from_numpy(p0, device="cpu", dtype=tdtype)
        js, ts = jo.init(jp), to.init(tp)
        jupdate = jax.jit(lambda g, s, p, key, v: jo.update(
            g, s, p, obj_fn=jobj, key=key, value=v, grad=g, value_fn=jobj))
        sophia_key = jax.random.PRNGKey(0)
        for t in range(STEPS):
            if name == "lbfgs":
                v, g = jax.value_and_grad(jobj)(jp)
                v = float(v)
                g_np = jax.tree.map(np.asarray, g)
            else:
                scale = 10.0 ** rng.uniform(-2, 1)     # the clip at 1.0 acts on some steps
                g_np = tuple((scale * rng.standard_normal(w.shape),
                              scale * rng.standard_normal(b.shape)) for w, b in p0)
                v = float(rng.uniform(1.0, 2.0))
            key = jax.random.fold_in(jax.random.PRNGKey(0), t)
            if name == "adahessian":
                keys = jax.random.split(key, 2 * len(p0))
                probes.append([jax.random.rademacher(k, np.shape(a), dtype)
                               for k, a in zip(keys, _leaves(p0))])
            if name == "sophia" and t % 10 == 0:
                sophia_key, sub = jax.random.split(sophia_key)
                z = optax.tree.random_like(sub, jp, jax.random.rademacher, dtype=jnp.float32)
                probes.append([np.asarray(a, dtype) for a in jax.tree.leaves(z)])
            jg = jax.tree.map(lambda a: jnp.asarray(a, dtype), g_np)
            ju, js = jupdate(jg, js, jp, key, jnp.asarray(v, dtype))
            tu, ts = to.update(params_from_numpy(g_np, device="cpu", dtype=tdtype), ts, tp,
                               value=torch.tensor(v, dtype=tdtype), obj_fn=tobj,
                               generator=gen)
            # a lookahead sync step's update is slow − p, a difference of
            # param-sized numbers: one f32 ulp of p is its floor
            ulp = (jax.tree.map(lambda a: np.finfo(np.float32).eps * np.abs(a).max(), jp)
                   if name == "ranger21" else None)
            _assert_tree(tu, ju, rtol, ulp)
            jp = optax.apply_updates(jp, ju)
            tp = tuple((w + uw, b + ub) for (w, b), (uw, ub) in zip(tp, tu))
        assert not probes
        _assert_tree(tp, jp, rtol)


def test_make_optimizer_names_and_clip_order():
    """Every name the JAX zoo accepts, an unknown one refused; the clip
    before every optimizer but adahessian, after it."""
    for name, kw, _ in CASES:
        opt = topt.make_optimizer("adam" if name == "plateau" else name, 1e-3,
                                  clip_norm=1.0, **kw)
        links = getattr(opt, "links", None)
        if links is None:
            assert isinstance(opt, topt.ClipAdam) and opt.clip == 1.0
            continue
        clip_at = [i for i, ln in enumerate(links) if isinstance(ln, topt.ClipByGlobalNorm)]
        assert clip_at == ([len(links) - 1] if name == "adahessian" else [0]), name
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("adagrad")
    with pytest.raises(ValueError, match="unknown optimizer"):
        jopt.make_optimizer("adagrad")


def _rosen_t(p):
    x = p["x"]
    return torch.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _rosen_j(p):
    x = p["x"]
    return jnp.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def test_lbfgs_matches_optax_on_rosenbrock():
    """20 steps of optax.lbfgs() (value and gradient from the line
    search's state, as optax.value_and_grad_from_state reuses them) from
    (−1.2, 1, 0.5, −0.3, 0.8): iterates and step sizes at 1e-9 in float64,
    the same number of line-search trials each step (zooms included)."""
    x0 = np.array([-1.2, 1.0, 0.5, -0.3, 0.8])
    with jax.enable_x64(True):
        jo = optax.lbfgs()
        jp = {"x": jnp.asarray(x0)}
        js = jo.init(jp)
        vg = optax.value_and_grad_from_state(_rosen_j)
        jupdate = jax.jit(lambda g, s, p, v: jo.update(g, s, p, value=v, grad=g,
                                                      value_fn=_rosen_j))
        vg = jax.jit(vg)
        to = tlbfgs.lbfgs()
        tp = {"x": torch.tensor(x0)}
        ts = to.init(tp)
        zooms = 0
        for _ in range(20):
            v, g = vg(jp, state=js)
            ju, js = jupdate(g, js, jp, v)
            jp = optax.apply_updates(jp, ju)
            last = tlbfgs.last_value_and_grad(to, ts)
            if last is None:
                tv, tg = tlbfgs.value_and_grad_of(lambda ls: _rosen_t({"x": ls[0]}), [tp["x"]])
            else:
                tv, tg = last
            np.testing.assert_allclose(float(tv), float(v), rtol=1e-9)
            tu, ts = to.update({"x": tg[0]}, ts, tp, value=tv, obj_fn=_rosen_t)
            tp = {"x": tp["x"] + tu["x"]}
            assert ts[2]["trials"] == int(js[2].info.num_linesearch_steps)
            zooms += ts[2]["trials"] > 1
            np.testing.assert_allclose(ts[2]["stepsize"], float(js[2].learning_rate),
                                       rtol=1e-9)
            np.testing.assert_allclose(tp["x"].numpy(), np.asarray(jp["x"]), rtol=1e-9,
                                       atol=1e-12)
    assert zooms >= 3


def _optax_lbfgs_fit(obj, params, steps):
    """The JAX package's `_lbfgs_fit` loop (optax.lbfgs(), the value and
    gradient from the line search's state, the best iterate kept) in the
    params' dtype."""
    opt = optax.lbfgs()
    state = opt.init(params)
    vg = jax.jit(optax.value_and_grad_from_state(obj))
    update = jax.jit(lambda g, s, p, v: opt.update(g, s, p, value=v, grad=g, value_fn=obj))
    best, best_l, losses = params, np.inf, []
    for _ in range(steps):
        v, g = vg(params, state=state)
        u, state = update(g, state, params, v)
        if float(v) < best_l:
            best, best_l = params, float(v)
        losses.append(float(v))
        params = optax.apply_updates(params, u)
    return (params if float(obj(params)) <= best_l else best), np.asarray(losses)


def test_lbfgs_fit_matches_optax_on_a_gpe_loss():
    """fit_hybrid's L-BFGS phase (`_lbfgs_fit`, 20 steps) on a small GPE
    loss — the sum of squares of the GPE residual vector, which is the fit
    loss, float64 throughout (the JAX package's own `_lbfgs_fit` keeps its
    best loss in f32) — against the same loop over optax.lbfgs: the loss
    before each step and the returned params at 1e-9."""
    from gpe_tpu.train.gauss_newton import make_gpe_residual_fn as jres_fn
    from gpe_tpu_torch.train.gauss_newton import make_gpe_residual_fn as tres_fn

    spec_kw = dict(n_points=64, layers=(1, 8, 8, 1))
    jspec = jprob.GPESpec(**spec_kw)
    tspec = tprob.GPESpec(**spec_kw)
    p0 = _np_params(spec_kw["layers"], 4)              # one batch (JAX's) for both
    jres, tres = jres_fn(jspec), tres_fn(tspec)
    batch = {k: np.asarray(v, np.float64) for k, v in jprob.make_batch(jspec, 0).items()}
    with jax.enable_x64(True):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p0)
        g64, s64 = jnp.float64(1.0), jnp.float64(0.1)
        jout, jl = _optax_lbfgs_fit(lambda p: jnp.sum(jres(p, jb, g64, s64) ** 2),
                                    jparams, 20)
        jout = jax.tree.map(np.asarray, jout)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tparams = params_from_numpy(p0, device="cpu", dtype=torch.float64)
    tout, tl = thybrid._lbfgs_fit(lambda *a: (torch.sum(tres(*a) ** 2),), tparams, tb,
                                  torch.tensor(1.0, dtype=torch.float64),
                                  torch.tensor(0.1, dtype=torch.float64), 20)
    assert jl[-1] < 0.5 * jl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    _assert_tree(tout, jout, 1e-9)


def test_fit_hands_the_extra_args_to_second_order_optimizers():
    """Sophia, AdaHessian and L-BFGS inside `fit`: they get params, the
    loss, the objective closure and the generator; the loss falls."""
    spec = tprob.GPESpec(n_points=128, layers=(1, 12, 12, 1))
    batch = tprob.make_batch(spec, 0, device="cpu")
    loss_fn = tprob.make_loss_fn(spec)
    params = params_from_numpy(_np_params(spec.layers, 2), device="cpu")
    first = float(loss_fn(params, batch, torch.tensor(0.0), torch.tensor(1.0))[0])
    for name in ("sophia", "adahessian", "lbfgs"):
        res = fit(loss_fn, topt.make_optimizer(name, 1e-3, clip_norm=1.0), params, batch,
                  0.0, 1.0, epochs=60, tol=0.0, patience=10**9, check_every=30)
        assert np.isfinite(res.best_loss) and res.best_loss < first, name


# --- the JAX package's own optimizer tests (tests/test_optimizers.py) ---------


def _quadratic(diag):
    d = torch.tensor(diag, dtype=torch.float32)
    return lambda p: 0.5 * torch.sum(d * p["w"] ** 2)


def _grad(loss, p):
    w = p["w"].detach().requires_grad_(True)
    with torch.enable_grad():
        return {"w": torch.autograd.grad(loss({"w": w}), w)[0]}


def _descend(opt, loss, params, steps, state=None, extra=None):
    """`steps` updates from `params` (and `state`, else a fresh one);
    extra: the update's keyword arguments."""
    state = opt.init(params) if state is None else state
    for _ in range(steps):
        u, state = opt.update(_grad(loss, params), state, params, **(extra or {}))
        params = {"w": params["w"] + u["w"]}
    return params, state


def test_qhadam_converges_on_quadratic():
    loss = _quadratic([1.0, 10.0, 100.0])
    params, _ = _descend(topt.qhadam(5e-2), loss, {"w": torch.ones(3)}, 400)
    assert float(loss(params)) < 1e-5


def test_qhadam_nu1_recovers_adam_direction():
    """ν₁ = ν₂ = 1 reduces QHAdam's update to Adam's m̂/(√v̂ + ε)."""
    g = {"w": torch.tensor([0.3, -0.7])}
    p = {"w": torch.zeros(2)}
    qh = topt.qhadam(1e-3, b1=0.9, b2=0.999, nu1=1.0, nu2=1.0)
    ad = topt.make_optimizer("adam", 1e-3)
    u1, _ = qh.update(g, qh.init(p), p)
    u2, _ = ad.update(g, ad.init(p), p)
    np.testing.assert_allclose(u1["w"].numpy(), u2["w"].numpy(), rtol=1e-4, atol=1e-8)


def test_adahessian_hutchinson_exact_for_diagonal_hessian():
    """For a diagonal Hessian z ⊙ (Hz) = diag·z² = diag, so after one step
    v = (1 − b2)·diag² whatever the probe."""
    diag = torch.tensor([2.0, 5.0, 0.5])
    loss = _quadratic(diag.tolist())
    params = {"w": torch.tensor([1.0, -1.0, 2.0])}
    opt = topt.adahessian(1e-1, b2=0.9)
    _, state = opt.update(_grad(loss, params), opt.init(params), params, obj_fn=loss,
                          generator=torch.Generator().manual_seed(7))
    np.testing.assert_allclose(state[0]["v"][0].numpy(), (0.1 * diag ** 2).numpy(),
                               rtol=1e-5)


def test_adahessian_converges_on_ill_conditioned_quadratic():
    loss = _quadratic([1.0, 1e3])
    gen = torch.Generator().manual_seed(0)
    params, _ = _descend(topt.adahessian(0.3), loss, {"w": torch.ones(2)}, 300,
                         extra=dict(obj_fn=loss, generator=gen))
    assert float(loss(params)) < 1e-4


@pytest.mark.parametrize("name", ["sophia", "adahessian", "qhadam"])
def test_second_order_optimizers_run_inside_fit(name):
    """fit supplies the objective and the generator: the best loss of 200
    steps is finite and below the first."""
    spec = tprob.GPESpec(n_points=256, layers=(1, 16, 16, 1))
    batch = tprob.make_batch(spec, 0, device="cpu")
    loss_fn = tprob.make_loss_fn(spec)
    params = tmlp.init_mlp(spec.layers, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    first = float(loss_fn(params, batch, torch.tensor(0.0), torch.tensor(1.0))[0])
    res = fit(loss_fn, topt.make_optimizer(name, 1e-3, clip_norm=1.0), params, batch,
              0.0, 1.0, epochs=200, tol=0.0, patience=10_000, check_every=100)
    assert np.isfinite(res.best_loss) and res.best_loss < first


def test_adahessian_clip_order_preserves_newton_scaling():
    """Clipping BEFORE adahessian shrank the update by the clip factor (the
    numerator clipped, the Hutchinson denominator not): make_optimizer clips
    the preconditioned update AFTER it."""
    loss = lambda p: 1e4 * torch.sum(p["w"] ** 2)
    params = {"w": torch.tensor([1.0, -2.0])}
    opt = topt.make_optimizer("adahessian", 1e-2, clip_norm=1.0)
    u, _ = opt.update(_grad(loss, params), opt.init(params), params, obj_fn=loss,
                      generator=torch.Generator().manual_seed(0))
    norm = float(torch.linalg.vector_norm(u["w"]))
    assert norm > 1e-3, f"update norm {norm:.2e}: the pre-clip shrinkage is back"


def test_curriculum_accepts_optimizer_name():
    from gpe_tpu_torch.train.curriculum import train_curriculum
    spec = tprob.GPESpec(lb=-10.0, ub=10.0, n_points=256, layers=(1, 16, 16, 1),
                         activation="tanh", use_perturbation=True)
    res = train_curriculum(spec, [0.0], epochs=150, check_every=150, optimizer="qhadam",
                           device="cpu")
    assert np.isfinite(res.mu_table[0][1])


def test_reduce_on_plateau_scales_updates():
    """Under a flat loss the plateau link halves the update scale every
    `patience` steps: two halvings in 10 steps."""
    opt = topt.make_optimizer("adam", 1e-3, plateau=dict(factor=0.5, patience=3))
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    for _ in range(10):
        u, state = opt.update({"w": torch.ones(3)}, state, params,
                              value=torch.tensor(1.0))
    assert float(torch.abs(u["w"][0])) < 0.5 * 1e-3


def test_reduce_on_plateau_inside_fit_runs():
    spec = tprob.GPESpec(lb=-8.0, ub=8.0, n_points=256, layers=(1, 16, 16, 1),
                         activation="tanh", use_perturbation=False)
    batch = tprob.make_batch(spec, 0, device="cpu")
    params = tmlp.init_mlp(spec.layers, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    opt = topt.make_optimizer("adam", 1e-3, clip_norm=1.0,
                              plateau=dict(factor=0.5, patience=50))
    res = fit(tprob.make_loss_fn(spec), opt, params, batch, 0.0, 1.0, epochs=200,
              check_every=100, tol=0.0, patience=10**9)
    assert np.isfinite(res.best_loss)


def test_lookahead_sync_semantics():
    """k = 2, α = 0.5 over plain SGD: after each sync step the params land
    on slow + α·(fast − slow) and the slow copy moves there too."""
    opt = topt.Chain(topt.ScaleByLearningRate(0.1), topt.Lookahead(k=2, alpha=0.5))
    p = {"w": torch.tensor([1.0])}
    state = opt.init(p)
    for want in (0.9, 0.9, 0.8, 0.8):
        u, state = opt.update({"w": torch.tensor([1.0])}, state, p)
        p = {"w": p["w"] + u["w"]}
        assert np.allclose(p["w"].numpy(), want)


def test_pnm_converges_and_alternates_buffers():
    loss = _quadratic([1.0, 10.0, 100.0])
    opt = topt.Chain(topt.ScaleByPNM(), topt.ScaleByLearningRate(5e-2))
    params, state = _descend(opt, loss, {"w": torch.ones(3)}, 1)
    assert float(torch.abs(state[0]["m_odd"][0]).sum()) > 0
    assert float(torch.abs(state[0]["m_even"][0]).sum()) == 0.0
    params, _ = _descend(opt, loss, params, 400, state)
    assert float(loss(params)) < 1e-5


def test_ranger21_full_converges_on_quadratic():
    """Full Ranger21 (centralize → AGC → PNM → wd → warmup lr → lookahead)."""
    loss = _quadratic([1.0, 10.0, 100.0])
    opt = topt.ranger21(5e-2, warmup_steps=20, weight_decay=0.0, total_steps=600)
    params, _ = _descend(opt, loss, {"w": torch.ones(3)}, 600)
    assert float(loss(params)) < 1e-4
