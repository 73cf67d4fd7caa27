"""Optimizers as small explicit transforms, functional like optax —
`init(params) -> state`, `update(grads, state, value) -> (updates, state)` —
so fit() can mask updates on the device. Params and grads are any tree of
tensors (torch.utils._pytree: the MLP's (W, b) pairs, or the self-adaptive
{"net", "log_alpha"} dict).

`ClipAdam` is the chain every ramp optimizer of `gpe_tpu/train/plpinn.py`
and `make_optimizer("adam", ...)` of `gpe_tpu/train/optimizers.py` build:

    clip_by_global_norm(clip) → scale_by_adam(b1, b2, eps, eps_root=0)
    → × loss_scale(loss) → × count_scale(count)

`count` is the number of updates before this one, the count optax's
`scale_by_schedule` reads (so a schedule's first update reads count 0).

`per_run=True` is the same chain over run-stacked leaves (a leading run
axis R), as `jax.vmap` of the optax chain computes it: the global norm and
the clip per run, Adam elementwise, and a loss factor per run from the (R,)
loss vector. The ensemble trainers (`loop.fit_ensemble`,
`packed.fit_ensemble_packed`) step with it; `per_run_form()` turns a
single-run optimizer into it.
"""
from __future__ import annotations

from typing import Callable

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

    def update(self, grads, state, value):
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


def make_optimizer(name: str, learning_rate: float | Callable = 1e-3,
                   clip_norm: float | None = None) -> ClipAdam:
    """`make_optimizer` of the JAX package for "adam" (optax.adam, after a
    global-norm clip when clip_norm is given); learning_rate is a float or
    a schedule of the update count. The other optimizers wait for their
    port."""
    if name.lower() != "adam":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet; see "
            "gpe_tpu.train.optimizers.make_optimizer")
    if callable(learning_rate):
        count_scale = lambda count: -learning_rate(count)
    else:
        count_scale = lambda count: -float(learning_rate)
    return ClipAdam(clip=clip_norm, count_scale=count_scale)
