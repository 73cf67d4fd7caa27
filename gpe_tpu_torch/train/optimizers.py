"""Optimizers as small explicit transforms, functional like optax, port of
`gpe_tpu/train/optimizers.py` (`make_optimizer` and its zoo).

Every optimizer has one protocol:

    init(params) -> state
    update(grads, state, params, *, value, obj_fn, generator) -> (updates, state)

`value` is the loss at `params`, `obj_fn(params) -> loss` the objective
closure (what the second-order optimizers differentiate twice and what
L-BFGS's line search evaluates), `generator` a CPU torch.Generator for the
Hessian probes (drawn on the CPU, then moved to the device: the card and
the CPU see the same probes). Params and grads are any tree of tensors
(torch.utils._pytree: the MLP's (W, b) pairs, the self-adaptive
{"net", "log_alpha"} dict, Helmholtz's dict with 0-d leaves).

`ClipAdam` is the chain every ramp optimizer of `gpe_tpu/train/plpinn.py`
and `make_optimizer("adam", ...)` build:

    clip_by_global_norm(clip) → scale_by_adam(b1, b2, eps, eps_root=0)
    → × loss_scale(loss) → × count_scale(count)

`count` is the number of updates before this one, the count optax's
`scale_by_schedule` reads (so a schedule's first update reads count 0).
It also takes its older call form `update(grads, state, loss)`.

`per_run=True` is the same chain over run-stacked leaves (a leading run
axis R), as `jax.vmap` of the optax chain computes it: the global norm and
the clip per run, Adam elementwise, and a loss factor per run from the (R,)
loss vector. The ensemble trainers (`loop.fit_ensemble`,
`packed.fit_ensemble_packed`) step with it; `per_run_form()` turns a
single-run optimizer into it.

The rest of the zoo is a `Chain` of links over the flat list of leaves,
each `init(leaves)` / `update(u, state, ctx) -> (u, state)` with the
arithmetic of the optax transform it names (optax 0.2.6); counts are host
integers, so the bias corrections are host numbers.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree


def _leaves(tree):
    return [t for pair in tree for t in pair]


def _pairs(leaves):
    return tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))


def _along(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """An (R,) vector shaped to broadcast over a run-stacked leaf g."""
    return v.reshape(-1, *([1] * (g.ndim - 1)))


def per_run_norms(leaves) -> torch.Tensor:
    """Per-run global norms (R,) of run-stacked leaves."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2, dim=tuple(range(1, g.ndim)))
                          for g in leaves))


def _times(leaves, factor):
    """Each leaf times `factor`: a number, a 0-dim tensor, or an (R,) vector
    of per-run factors along the leaves' run axis."""
    if isinstance(factor, torch.Tensor) and factor.ndim == 1:
        return [g * _along(factor, g) for g in leaves]
    return torch._foreach_mul(leaves, factor)


def scale_by_adam(g, state, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8):
    """optax.scale_by_adam (eps_root = 0) on a list of tensors `g` with
    state {"mu", "nu", "count"}: returns (updates, new state)."""
    mu = torch._foreach_mul(state["mu"], b1)
    torch._foreach_add_(mu, g, alpha=1.0 - b1)
    nu = torch._foreach_mul(state["nu"], b2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
    count = state["count"] + 1.0
    bc1 = 1.0 - torch.pow(torch.full_like(count, b1), count)
    bc2 = 1.0 - torch.pow(torch.full_like(count, b2), count)
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, eps)
    u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    return u, {"mu": mu, "nu": nu, "count": count}


def adam_init(leaves) -> dict:
    return {"mu": [torch.zeros_like(t) for t in leaves],
            "nu": [torch.zeros_like(t) for t in leaves],
            "count": torch.zeros((), dtype=torch.float32, device=leaves[0].device)}


class ClipAdam:
    """Global-norm clip (none when clip is None), Adam (optax.scale_by_adam
    defaults), then a factor `loss_scale(loss)` (the loss-as-step LR, e.g.
    −schedule(loss)) and a factor `count_scale(count)` (a step-count
    schedule, −lr for a plain Adam). per_run=True: run-stacked leaves, each
    run clipped by its own norm and scaled by its own loss."""

    def __init__(self, loss_scale: Callable | None = None,
                 clip: float | None = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, count_scale: Callable | None = None,
                 per_run: bool = False):
        self.loss_scale, self.clip = loss_scale, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count_scale, self.per_run = count_scale, per_run

    def per_run_form(self) -> "ClipAdam":
        """This chain for run-stacked leaves (per-run clip and loss)."""
        return ClipAdam(self.loss_scale, self.clip, self.b1, self.b2, self.eps,
                        self.count_scale, per_run=True)

    def init(self, params):
        return adam_init(pytree.tree_leaves(params))

    def update(self, grads, state, params=None, *, value=None, obj_fn=None,
               generator=None):
        """The protocol's update; `update(grads, state, loss)` (the loss in
        the params slot, no `value=`) is the chain's older call form."""
        if value is None:
            value = params
        g, spec = pytree.tree_flatten(grads)
        if self.clip is not None and self.per_run:
            g = _times(g, self.clip / torch.clamp_min(per_run_norms(g), self.clip))
        elif self.clip is not None:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            factor = torch.where(g_norm < self.clip, torch.ones_like(g_norm),
                                 self.clip / g_norm)
            g = torch._foreach_mul(g, factor)
        count = state["count"]
        u, state = scale_by_adam(g, state, self.b1, self.b2, self.eps)
        if self.loss_scale is not None:
            u = _times(u, self.loss_scale(value.detach()))
        if self.count_scale is not None:
            u = _times(u, self.count_scale(count))
        return pytree.tree_unflatten(u, spec), state


# --------------------------------------------------------------------------
# The zoo: links over the flat list of leaves, chained.


class Ctx(NamedTuple):
    """What a link sees besides the updates: the params' leaves, the loss
    at them, the raw (unclipped) gradient's leaves, the objective on a
    leaf list, and the probe generator."""
    params: list
    value: torch.Tensor | None
    grad: list
    obj: Callable | None
    generator: torch.Generator | None

    def sub(self, idx) -> "Ctx":
        """The context of the leaves at positions `idx` (no objective: it
        takes the whole leaf list)."""
        return self._replace(params=[self.params[i] for i in idx],
                             grad=[self.grad[i] for i in idx], obj=None)


def vdot(a, b) -> torch.Tensor:
    """Σ over leaves of ⟨a, b⟩ (optax.tree.vdot), a 0-d tensor."""
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def global_norm(u) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x * x) for x in u))


def _bc(decay: float, count: int) -> float:
    """optax.tree.bias_correction's divisor 1 − decay^count."""
    return 1.0 - decay ** count


def _moment(u, m, decay: float, order: int = 1):
    """optax.tree.update_moment: (1 − decay)·g^order + decay·m."""
    return [(1 - decay) * (g ** order if order != 1 else g) + decay * t
            for g, t in zip(u, m)]


def _lr_at(lr, count: int):
    return lr(count) if callable(lr) else lr


def rademacher_like(leaves, generator: torch.Generator | None):
    """Hutchinson's probe: ±1 per entry of each leaf, drawn on the CPU from
    `generator` and moved to the leaf's device and dtype."""
    return [(torch.randint(0, 2, t.shape, generator=generator) * 2 - 1)
            .to(device=t.device, dtype=t.dtype) for t in leaves]


def hutchinson_diag(obj: Callable, params, z):
    """z ⊙ (H z) for the Hessian H of obj at the leaf list `params`: the
    Hessian-vector product by double backward (forward-over-reverse in the
    JAX package; the same product)."""
    leaves = [t.detach().requires_grad_(True) for t in params]
    with torch.enable_grad():
        g = torch.autograd.grad(obj(leaves), leaves, create_graph=True,
                                allow_unused=True)
        live = [i for i, gi in enumerate(g) if gi is not None and gi.requires_grad]
        hz = torch.autograd.grad([g[i] for i in live], leaves,
                                 grad_outputs=[z[i] for i in live], allow_unused=True)
    return [a * (torch.zeros_like(a) if b is None else b.detach())
            for a, b in zip(z, hz)]


class Chain:
    """optax.chain over the flat leaves: each link's updates feed the next.
    `init` takes a params tree (or a leaf list); `step` is the chain as a
    link (Partition's sub-chains)."""

    def __init__(self, *links):
        self.links = [ln for ln in links if ln is not None]

    def init(self, params):
        leaves = pytree.tree_leaves(params)
        return [ln.init(leaves) for ln in self.links]

    def step(self, u, state, ctx):
        new = []
        for ln, st in zip(self.links, state):
            u, st = ln.update(u, st, ctx)
            new.append(st)
        return u, new

    def update(self, grads, state, params=None, *, value=None, obj_fn=None,
               generator=None):
        u, spec = pytree.tree_flatten(grads)
        p = pytree.tree_leaves(params) if params is not None else None
        obj = (None if obj_fn is None
               else lambda leaves: obj_fn(pytree.tree_unflatten(leaves, spec)))
        u, new = self.step(u, state, Ctx(p, value, list(u), obj, generator))
        return pytree.tree_unflatten(list(u), spec), new


class ClipByGlobalNorm:
    """optax.clip_by_global_norm: t where ‖u‖ < max_norm, else t/‖u‖·max_norm."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, leaves):
        return None

    def update(self, u, state, ctx):
        norm = global_norm(u)
        keep = norm < self.max_norm
        return [torch.where(keep, t, t / norm * self.max_norm) for t in u], state


class ScaleByLearningRate:
    """optax.scale_by_learning_rate: × −lr, or × −lr(count) for a schedule
    (count = the updates before this one)."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, leaves):
        return 0

    def update(self, u, count, ctx):
        if callable(self.lr):
            return [t * -self.lr(count) for t in u], count + 1
        return [t * -self.lr for t in u], count


class AddDecayedWeights:
    """optax.add_decayed_weights: u + wd·p."""

    def __init__(self, weight_decay: float):
        self.wd = weight_decay

    def init(self, leaves):
        return None

    def update(self, u, state, ctx):
        return [t + self.wd * p for t, p in zip(u, ctx.params)], state


class ScaleByAdam:
    """optax.scale_by_adam, Nesterov's form included."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, nesterov=False):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.nesterov = nesterov

    def init(self, leaves):
        return {"count": 0, "mu": [torch.zeros_like(t) for t in leaves],
                "nu": [torch.zeros_like(t) for t in leaves]}

    def update(self, u, s, ctx):
        b1, b2 = self.b1, self.b2
        mu = _moment(u, s["mu"], b1)
        nu = _moment(u, s["nu"], b2, 2)
        c = s["count"] + 1
        if self.nesterov:
            mu_hat = [b1 * (m / _bc(b1, c + 1)) + (1 - b1) * (g / _bc(b1, c))
                      for m, g in zip(mu, u)]
        else:
            mu_hat = [m / _bc(b1, c) for m in mu]
        out = [m / (torch.sqrt(v / _bc(b2, c) + self.eps_root) + self.eps)
               for m, v in zip(mu_hat, nu)]
        return out, {"count": c, "mu": mu, "nu": nu}


class ScaleByBelief:
    """optax.scale_by_belief (AdaBelief's moments)."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16):
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, leaves):
        return {"count": 0, "mu": [torch.zeros_like(t) for t in leaves],
                "nu": [torch.zeros_like(t) for t in leaves]}

    def update(self, u, s, ctx):
        mu = _moment(u, s["mu"], self.b1)
        err = [g - m for g, m in zip(u, mu)]
        nu = [v + self.eps_root for v in _moment(err, s["nu"], self.b2, 2)]
        c = s["count"] + 1
        out = [(m / _bc(self.b1, c)) / (torch.sqrt(v / _bc(self.b2, c)) + self.eps)
               for m, v in zip(mu, nu)]
        return out, {"count": c, "mu": mu, "nu": nu}


class ScaleByRms:
    """optax.scale_by_rms (its defaults: no bias correction, eps inside the
    root): u·rsqrt(ν + eps)."""

    def __init__(self, decay=0.9, eps=1e-8):
        self.decay, self.eps = decay, eps

    def init(self, leaves):
        return [torch.zeros_like(t) for t in leaves]

    def update(self, u, nu, ctx):
        nu = _moment(u, nu, self.decay, 2)
        return [torch.rsqrt(v + self.eps) * g for v, g in zip(nu, u)], nu


class QHAdam:
    """Quasi-hyperbolic Adam (JAX `qhadam`): update
    −lr·[(1−ν₁)g + ν₁m̂] / (√[(1−ν₂)g² + ν₂v̂] + ε), the bias corrections in
    f32 as the JAX package computes them."""

    def __init__(self, learning_rate=1e-3, b1=0.995, b2=0.999, nu1=0.7, nu2=1.0,
                 eps=1e-8):
        self.lr, self.b1, self.b2, self.nu1, self.nu2, self.eps = (
            learning_rate, b1, b2, nu1, nu2, eps)

    def init(self, leaves):
        return {"count": 0, "m": [torch.zeros_like(t) for t in leaves],
                "v": [torch.zeros_like(t) for t in leaves]}

    def update(self, u, s, ctx):
        b1, b2, nu1, nu2 = self.b1, self.b2, self.nu1, self.nu2
        c = s["count"] + 1
        m = [b1 * mm + (1 - b1) * g for mm, g in zip(s["m"], u)]
        v = [b2 * vv + (1 - b2) * g * g for vv, g in zip(s["v"], u)]
        c1, c2 = _f32_bc(b1, c), _f32_bc(b2, c)
        lr = _lr_at(self.lr, c)
        out = [-lr * ((1 - nu1) * g + nu1 * (mm / c1))
               / (torch.sqrt((1 - nu2) * g * g + nu2 * (vv / c2)) + self.eps)
               for g, mm, vv in zip(u, m, v)]
        return out, {"count": c, "m": m, "v": v}


def _f32_bc(decay: float, count: int) -> float:
    """1 − decay^count in f32 arithmetic (the JAX package's own transforms
    cast the count to f32)."""
    f = torch.tensor(decay, dtype=torch.float32)
    return float(1.0 - f ** torch.tensor(float(count), dtype=torch.float32))


class AdaHessian:
    """AdaHessian (JAX `adahessian`): Adam with the second moment tracking
    Hutchinson's estimate z ⊙ (H z) of the Hessian diagonal, one Rademacher
    z a step (`rademacher_like` from the fit's generator)."""

    def __init__(self, learning_rate=0.1, b1=0.9, b2=0.999, eps=1e-8,
                 hessian_power=1.0):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.k_pow = hessian_power / 2.0

    def init(self, leaves):
        return {"count": 0, "m": [torch.zeros_like(t) for t in leaves],
                "v": [torch.zeros_like(t) for t in leaves]}

    def update(self, u, s, ctx):
        if ctx.obj is None or ctx.params is None:
            raise ValueError("adahessian needs params, obj_fn= and generator= "
                             "(gpe_tpu_torch.train.fit passes them)")
        z = rademacher_like(ctx.params, ctx.generator)
        return self.moments(u, hutchinson_diag(ctx.obj, ctx.params, z), s)

    def moments(self, u, diag, s):
        """The step from the gradient `u` and the Hessian-diagonal estimate."""
        b1, b2 = self.b1, self.b2
        c = s["count"] + 1
        m = [b1 * mm + (1 - b1) * g for mm, g in zip(s["m"], u)]
        v = [b2 * vv + (1 - b2) * d * d for vv, d in zip(s["v"], diag)]
        c1, c2 = _f32_bc(b1, c), _f32_bc(b2, c)
        lr = _lr_at(self.lr, c)
        out = [-lr * (mm / c1) / (torch.pow(vv / c2, self.k_pow) + self.eps)
               for mm, vv in zip(m, v)]
        return out, {"count": c, "m": m, "v": v}


class ScaleBySophia:
    """optax.contrib.scale_by_sophia with Hutchinson's estimator: the update
    m̂ / max(γ·h, eps) clipped to ±clip_threshold from the Hessian EMA h of
    the previous steps; h refreshed every `update_interval` steps (before
    the 1st, 11th, ... update) from a probe drawn from the optimizer's own
    generator (seeded 0, as optax's PRNGKey(0)), not the fit's."""

    def __init__(self, b1=0.965, b2=0.99, eps=1e-8, gamma=0.01,
                 clip_threshold=1.0, update_interval=10):
        self.b1, self.b2, self.eps, self.gamma = b1, b2, eps, gamma
        self.clip, self.interval = clip_threshold, update_interval

    def init(self, leaves):
        return {"count": 0, "mu": [torch.zeros_like(t) for t in leaves],
                "nu": [torch.zeros_like(t) for t in leaves],
                "generator": torch.Generator().manual_seed(0)}

    def update(self, u, s, ctx):
        diag = None
        if s["count"] % self.interval == 0:
            if ctx.obj is None or ctx.params is None:
                raise ValueError("sophia needs params and obj_fn= (gpe_tpu_torch."
                                 "train.fit passes them)")
            z = rademacher_like(ctx.params, s["generator"])
            diag = hutchinson_diag(ctx.obj, ctx.params, z)
        return self.moments(u, diag, s)

    def moments(self, u, diag, s):
        """The step from the gradient `u` and, on a refresh step, the
        Hessian-diagonal estimate (None between refreshes)."""
        c = s["count"] + 1
        mu = _moment(u, s["mu"], self.b1)
        out = [(m / _bc(self.b1, c)) / torch.clamp_min(self.gamma * h, self.eps)
               for m, h in zip(mu, s["nu"])]
        if self.clip is not None:
            out = [torch.clamp(t, -self.clip, self.clip) for t in out]
        nu = s["nu"] if diag is None else _moment(diag, s["nu"], self.b2)
        return out, {"count": c, "mu": mu, "nu": nu, "generator": s["generator"]}


NS_COEFFS = (3.4445, -4.7750, 2.0315)


def orthogonalize(x: torch.Tensor, steps: int = 5, eps: float = 1e-8) -> torch.Tensor:
    """optax.contrib.orthogonalize_via_newton_schulz of a matrix: the
    quintic Newton–Schulz iteration on x/‖x‖_F (on xᵀ when x is tall)."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.vector_norm(x) + eps)
    a0, a1, a2 = NS_COEFFS
    for _ in range(steps):
        a = x @ x.T
        b = a1 * a + (a2 * a) @ a
        x = a0 * x + b @ x
    return x.T if transposed else x


class ScaleByMuon:
    """optax.contrib.scale_by_muon on matrices (Nesterov momentum β, then
    Newton–Schulz, then × √max(1, fan_out/fan_in))."""

    def __init__(self, beta=0.95, steps=5, eps=1e-8):
        self.beta, self.steps, self.eps = beta, steps, eps

    def init(self, leaves):
        return {"count": 0, "mu": [torch.zeros_like(t) for t in leaves]}

    def update(self, u, s, ctx):
        beta = self.beta
        mu = _moment(u, s["mu"], beta)
        c = s["count"] + 1
        mu_hat = [beta * (m / _bc(beta, c + 1)) + (1 - beta) * (g / _bc(beta, c))
                  for m, g in zip(mu, u)]
        out = [math.sqrt(max(1.0, x.shape[1] / x.shape[0]))
               * orthogonalize(x, self.steps, self.eps) for x in mu_hat]
        return out, {"count": c, "mu": mu}


class Partition:
    """optax.combine.partition over two label sets: the chain `a` steps the
    leaves where select(leaf) holds, the chain `b` the rest."""

    def __init__(self, select: Callable, a, b):
        self.select, self.a, self.b = select, a, b

    def _split(self, leaves):
        ia = [i for i, t in enumerate(leaves) if self.select(t)]
        ib = [i for i, t in enumerate(leaves) if not self.select(t)]
        return ia, ib

    def init(self, leaves):
        ia, ib = self._split(leaves)
        return {"a": self.a.init([leaves[i] for i in ia]) if ia else None,
                "b": self.b.init([leaves[i] for i in ib]) if ib else None}

    def update(self, u, s, ctx):
        ia, ib = self._split(u)
        out, new = list(u), {}
        for key, idx, link in (("a", ia, self.a), ("b", ib, self.b)):
            if not idx:
                new[key] = s[key]
                continue
            sub, new[key] = link.step([u[i] for i in idx], s[key], ctx.sub(idx))
            for i, t in zip(idx, sub):
                out[i] = t
        return out, new


class Prodigy:
    """optax.contrib.prodigy (without its safeguard_warmup): D-adapted
    AdamW whose step estimate grows with ⟨g, x₀ − x⟩ (the update carries
    its own sign and LR)."""

    def __init__(self, learning_rate=1.0, betas=(0.9, 0.999), beta3=None,
                 eps=1e-8, estim_lr0=1e-6, estim_lr_coef=1.0, weight_decay=0.0):
        self.lr, (self.b1, self.b2) = learning_rate, betas
        self.b3 = betas[1] ** 0.5 if beta3 is None else beta3
        self.eps, self.lr0, self.coef = eps, estim_lr0, estim_lr_coef
        self.wd = weight_decay

    def init(self, leaves):
        t = leaves[0]
        zeros = lambda: [torch.zeros_like(x) for x in leaves]
        return {"exp_avg": zeros(), "exp_avg_sq": zeros(), "grad_sum": zeros(),
                "params0": [x.detach().clone() for x in leaves],
                "estim_lr": torch.tensor(self.lr0, dtype=t.dtype, device=t.device),
                "numerator_weighted": torch.zeros((), dtype=t.dtype, device=t.device),
                "count": 0}

    def update(self, u, s, ctx):
        b1, b2, b3 = self.b1, self.b2, self.b3
        c = s["count"] + 1
        sched = _lr_at(self.lr, s["count"])
        estim_lr = s["estim_lr"]
        bc = ((1 - b2 ** c) ** 0.5) / (1 - b1 ** c)
        dlr = estim_lr * sched * bc
        dg = [estim_lr * g for g in u]
        diff = [p0 - p for p0, p in zip(s["params0"], ctx.params)]
        num_acc = vdot(u, diff)
        exp_avg = [b1 * ea + (1 - b1) * d for ea, d in zip(s["exp_avg"], dg)]
        exp_avg_sq = [b2 * ea + (1 - b2) * d * d for ea, d in zip(s["exp_avg_sq"], dg)]
        grad_sum = [b3 * sk + dlr * d / self.lr0 for sk, d in zip(s["grad_sum"], dg)]
        nw = b3 * s["numerator_weighted"] + (estim_lr / self.lr0) * dlr * num_acc
        denom = sum(torch.sum(torch.abs(g)) for g in grad_sum)
        estim_lr = torch.maximum(s["estim_lr"], self.coef * nw / denom)
        out = [-self.wd * dlr * p - dlr * ea / (torch.sqrt(es) + estim_lr * self.eps)
               for ea, es, p in zip(exp_avg, exp_avg_sq, ctx.params)]
        return out, {"exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq,
                     "grad_sum": grad_sum, "params0": s["params0"],
                     "estim_lr": estim_lr, "numerator_weighted": nw, "count": c}


class ScaleByPNM:
    """Positive–negative momentum (JAX `scale_by_pnm`, Ranger21's first
    moment): two buffers updated on alternating steps with β₁², combined as
    ((1+k)·m_t − k·m_{t−1})/√((1+k)² + k²), over Adam's second moment."""

    def __init__(self, b1=0.9, b2=0.999, pnm_factor=1.0, eps=1e-8):
        self.b1, self.b2, self.k, self.eps = b1, b2, pnm_factor, eps
        self.norm = float(torch.sqrt(torch.tensor((1 + pnm_factor) ** 2 + pnm_factor ** 2,
                                                  dtype=torch.float32)))

    def init(self, leaves):
        zeros = lambda: [torch.zeros_like(t) for t in leaves]
        return {"count": 0, "m_odd": zeros(), "m_even": zeros(), "nu": zeros()}

    def update(self, u, s, ctx):
        b1sq, b2, k = self.b1 * self.b1, self.b2, self.k
        c = s["count"] + 1
        odd = c % 2 == 1
        step = lambda bufs: [b1sq * m + (1 - b1sq) * g for m, g in zip(bufs, u)]
        m_odd = step(s["m_odd"]) if odd else s["m_odd"]
        m_even = s["m_even"] if odd else step(s["m_even"])
        nu = [b2 * v + (1 - b2) * g * g for v, g in zip(s["nu"], u)]
        c1, c2 = _f32_bc(self.b1, c), _f32_bc(b2, c)
        now, prev = (m_odd, m_even) if odd else (m_even, m_odd)
        out = [(((1 + k) * mt - k * mp) / self.norm / c1) / (torch.sqrt(v / c2) + self.eps)
               for mt, mp, v in zip(now, prev, nu)]
        return out, {"count": c, "m_odd": m_odd, "m_even": m_even, "nu": nu}


class Lookahead:
    """Lookahead as a final link (JAX `lookahead`): every k-th step the
    update lands the params on slow + α·(fast − slow), and the slow copy
    (kept in the state) moves there too."""

    def __init__(self, k: int = 5, alpha: float = 0.5):
        self.k, self.alpha = k, alpha

    def init(self, leaves):
        return {"count": 0, "slow": [t.detach().clone() for t in leaves]}

    def update(self, u, s, ctx):
        c = s["count"] + 1
        if c % self.k:
            return u, {"count": c, "slow": s["slow"]}
        slow = [sl + self.alpha * (p + t - sl) for t, p, sl in zip(u, ctx.params, s["slow"])]
        return [sn - p for sn, p in zip(slow, ctx.params)], {"count": c, "slow": slow}


class Centralize:
    """optax.centralize: each leaf of rank > 1 less its mean over all axes
    but the first."""

    def init(self, leaves):
        return None

    def update(self, u, state, ctx):
        return [g - g.mean(dim=tuple(range(1, g.ndim)), keepdim=True) if g.ndim > 1
                else g for g in u], state


def _unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    """optax's unitwise_norm for rank ≤ 2: the whole (squeezed) vector, or
    the columns of a matrix (axis 0)."""
    if x.squeeze().ndim <= 1:
        n = torch.sqrt(torch.sum(x * x))
    else:
        n = torch.sqrt(torch.sum(x * x, dim=0, keepdim=True))
    return n.expand(x.shape)


class AdaptiveGradClip:
    """optax.adaptive_grad_clip: each unit's update at most
    clipping·max(‖p‖, eps)."""

    def __init__(self, clipping: float, eps: float = 1e-3):
        self.clipping, self.eps = clipping, eps

    def init(self, leaves):
        return None

    def update(self, u, state, ctx):
        out = []
        for g, p in zip(u, ctx.params):
            g_norm = _unitwise_norm(g)
            max_norm = self.clipping * torch.clamp_min(_unitwise_norm(p), self.eps)
            clipped = g * (max_norm / torch.clamp_min(g_norm, 1e-6))
            out.append(torch.where(g_norm < max_norm, g, clipped))
        return out, state


class ReduceOnPlateau:
    """optax.contrib.reduce_on_plateau (accumulation 1): the updates times a
    scale that drops by `factor` after `patience` steps without a relative
    improvement of the loss below (1 − rtol)·best − atol."""

    def __init__(self, factor=0.1, patience=10, rtol=1e-4, atol=0.0, cooldown=0,
                 min_scale=0.0):
        self.factor, self.patience, self.rtol, self.atol = factor, patience, rtol, atol
        self.cooldown, self.min_scale = cooldown, min_scale

    def init(self, leaves):
        t = leaves[0]
        return {"best": torch.tensor(float("inf"), dtype=t.dtype, device=t.device),
                "plateau": torch.zeros((), dtype=torch.int64, device=t.device),
                "scale": torch.ones((), dtype=t.dtype, device=t.device),
                "cooldown": torch.zeros((), dtype=torch.int64, device=t.device)}

    def update(self, u, s, ctx):
        value = torch.as_tensor(ctx.value, dtype=s["best"].dtype,
                                device=s["best"].device).detach()
        improved = value < (1 - self.rtol) * s["best"] - self.atol
        best = torch.where(improved, value, s["best"])
        plateau = torch.where(improved, torch.zeros_like(s["plateau"]), s["plateau"] + 1)
        hit = plateau == self.patience
        cooling = s["cooldown"] > 0
        new_plateau = torch.where(cooling | hit, torch.zeros_like(plateau), plateau)
        scale = torch.where(cooling, s["scale"], torch.clamp_min(
            torch.where(hit, s["scale"] * self.factor, s["scale"]), self.min_scale))
        cool = torch.where(cooling, s["cooldown"] - 1, torch.where(
            hit, torch.full_like(s["cooldown"], self.cooldown), torch.zeros_like(s["cooldown"])))
        new = {"best": best, "plateau": new_plateau, "scale": scale, "cooldown": cool}
        return [scale * t for t in u], new


# --------------------------------------------------------------------------
# The named optimizers of the JAX zoo.


def qhadam(learning_rate=1e-3, **kw) -> Chain:
    return Chain(QHAdam(learning_rate, **kw))


def adahessian(learning_rate=0.1, **kw) -> Chain:
    return Chain(AdaHessian(learning_rate, **kw))


def sophia(learning_rate, b1=0.965, b2=0.99, eps=1e-8, weight_decay=1e-4,
           gamma=0.01, clip_threshold=1.0, update_interval=10) -> Chain:
    """optax.contrib.sophia: scale_by_sophia → add_decayed_weights → lr."""
    return Chain(ScaleBySophia(b1, b2, eps, gamma, clip_threshold, update_interval),
                 AddDecayedWeights(weight_decay), ScaleByLearningRate(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          weight_decay=1e-4, nesterov=False) -> Chain:
    return Chain(ScaleByAdam(b1, b2, eps, eps_root, nesterov),
                 AddDecayedWeights(weight_decay), ScaleByLearningRate(learning_rate))


def muon(learning_rate, ns_steps=5, beta=0.95, eps=1e-8, weight_decay=0.0,
         adam_b1=0.9, adam_b2=0.999, adam_eps_root=0.0,
         adam_weight_decay=0.0) -> Chain:
    """optax.contrib.muon (Nesterov, its default): Newton–Schulz on the
    leaves with ndim == 2, AdamW with Nesterov momentum (muon passes its
    `nesterov` on) on the rest."""
    matrices = Chain(ScaleByMuon(beta, ns_steps, eps),
                     AddDecayedWeights(weight_decay), ScaleByLearningRate(learning_rate))
    rest = adamw(learning_rate, adam_b1, adam_b2, eps, adam_eps_root,
                 adam_weight_decay, nesterov=True)
    return Chain(Partition(lambda t: t.ndim == 2, matrices, rest))


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0) -> Callable:
    """optax.linear_schedule on host counts."""
    def schedule(count):
        if transition_steps <= 0:
            return init_value
        c = min(max(count - transition_begin, 0), transition_steps)
        return (init_value - end_value) * (1 - c / transition_steps) + end_value
    return schedule


def join_schedules(schedules, boundaries) -> Callable:
    """optax.join_schedules: past boundary i, schedule i+1 at count − boundary."""
    def schedule(count):
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out
    return schedule


def ranger21(learning_rate=1e-3, b1=0.9, b2=0.999, weight_decay=1e-4,
             agc_clip=1e-2, warmup_steps=300, warmdown_frac=0.28,
             total_steps: int | None = None, use_pnm=True, pnm_factor=1.0,
             lookahead_k=5, lookahead_alpha=0.5) -> Chain:
    """Ranger21 (JAX `ranger21`): centralize → AGC → PNM (Adam moments with
    use_pnm=False) → decoupled weight decay → linear warmup (+ warmdown
    with total_steps) → lookahead (lookahead_k ≤ 1 disables)."""
    if callable(learning_rate):
        sched = learning_rate
    elif total_steps is not None:
        down = max(int(warmdown_frac * total_steps), 1)
        sched = join_schedules(
            [linear_schedule(0.0, learning_rate, warmup_steps),
             lambda c: learning_rate,
             linear_schedule(learning_rate, 1e-8, down)],
            [warmup_steps, max(total_steps - down, warmup_steps)])
    else:
        sched = linear_schedule(0.0, learning_rate, warmup_steps)
    core = ScaleByPNM(b1, b2, pnm_factor) if use_pnm else ScaleByAdam(b1, b2)
    la = Lookahead(lookahead_k, lookahead_alpha) if lookahead_k and lookahead_k > 1 else None
    return Chain(Centralize(), AdaptiveGradClip(agc_clip), core,
                 AddDecayedWeights(weight_decay), ScaleByLearningRate(sched), la)


def make_optimizer(name: str, learning_rate: float | Callable = 1e-3,
                   clip_norm: float | None = None, plateau: dict | None = None,
                   **kwargs):
    """An optimizer of the zoo by name, after a global-norm clip when
    clip_norm is given — clipped after the optimizer for "adahessian",
    whose denominator comes from the unclipped Hessian diagonal (clipping
    its numerator alone shrank the update by the clip factor and froze the
    net). learning_rate: a float or a schedule of the update count.
    `plateau` chains reduce-on-plateau after it (keys factor, patience,
    min_scale, rtol, cooldown; defaults factor 0.5, patience 500,
    min_scale 1e-4, rtol 1e-4), stepped on each update's `value`.

    Names: adam, adamw (b2 0.99), qhadam, adahessian, adabelief, sophia,
    rmsprop, sgd, muon, prodigy, ranger21, shampoo / distributed_shampoo,
    lbfgs (zoom line search, memory 10)."""
    name = name.lower()
    if name == "adam" and plateau is None:
        if callable(learning_rate):
            count_scale = lambda count: -learning_rate(count)
        else:
            count_scale = lambda count: -float(learning_rate)
        return ClipAdam(clip=clip_norm, count_scale=count_scale, **kwargs)
    if name == "adam":
        links = [ScaleByAdam(**kwargs), ScaleByLearningRate(learning_rate)]
    elif name == "adamw":
        kwargs.setdefault("b2", 0.99)
        links = adamw(learning_rate, **kwargs).links
    elif name == "qhadam":
        links = [QHAdam(learning_rate, **kwargs)]
    elif name == "adahessian":
        links = [AdaHessian(learning_rate, **kwargs)]
    elif name == "adabelief":
        links = [ScaleByBelief(**kwargs), ScaleByLearningRate(learning_rate)]
    elif name == "sophia":
        links = sophia(learning_rate, **kwargs).links
    elif name == "rmsprop":
        links = [ScaleByRms(**kwargs), ScaleByLearningRate(learning_rate)]
    elif name == "sgd":
        links = [ScaleByLearningRate(learning_rate)]
    elif name == "muon":
        links = muon(learning_rate, **kwargs).links
    elif name == "prodigy":
        links = [Prodigy(learning_rate, **kwargs)]
    elif name == "ranger21":
        links = ranger21(learning_rate, **kwargs).links
    elif name in ("shampoo", "distributed_shampoo"):
        from gpe_tpu_torch.train.shampoo import shampoo
        links = shampoo(learning_rate, **kwargs).links
    elif name == "lbfgs":
        from gpe_tpu_torch.train.lbfgs import lbfgs
        links = lbfgs(learning_rate, **kwargs).links
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if plateau is not None:
        cfg = dict(factor=0.5, patience=500, min_scale=1e-4, rtol=1e-4)
        cfg.update(plateau)
        links.append(ReduceOnPlateau(**cfg))
    if clip_norm is not None:
        clip = ClipByGlobalNorm(clip_norm)
        links = links + [clip] if name == "adahessian" else [clip] + links
    return Chain(*links)
