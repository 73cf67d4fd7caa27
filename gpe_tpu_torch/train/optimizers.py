"""The ramp optimizer as a small explicit transform (the port of the optax
chain in `gpe_tpu/train/plpinn.py:ramp_optimizer`, "loss_faithful" mode):

    clip_by_global_norm(clip) → scale_by_adam(b1, b2, eps, eps_root=0)
    → scale_by_loss_as_step(schedule): −schedule(loss)·update

Functional like optax — `init(params) -> state`,
`update(grads, state, value) -> (updates, state)` — so fit() can mask
updates on the device. Params and grads are tuples of (W, b).
"""
from __future__ import annotations

import torch


def _leaves(tree):
    return [t for pair in tree for t in pair]


def _pairs(leaves):
    return tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))


class ClipAdam:
    """Global-norm clip, Adam (optax.scale_by_adam defaults), then
    `step(updates, loss)` — e.g. schedules.scale_by_loss_as_step."""

    def __init__(self, step, clip: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.step, self.clip, self.b1, self.b2, self.eps = step, clip, b1, b2, eps

    def init(self, params):
        leaves = _leaves(params)
        return {"mu": [torch.zeros_like(t) for t in leaves],
                "nu": [torch.zeros_like(t) for t in leaves],
                "count": torch.zeros((), dtype=torch.float32,
                                     device=leaves[0].device)}

    def update(self, grads, state, value):
        g = _leaves(grads)
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        factor = torch.where(g_norm < self.clip, torch.ones_like(g_norm),
                             self.clip / g_norm)
        g = torch._foreach_mul(g, factor)
        mu = torch._foreach_mul(state["mu"], self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        nu = torch._foreach_mul(state["nu"], self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = state["count"] + 1.0
        bc1 = 1.0 - torch.pow(torch.full_like(count, self.b1), count)
        bc2 = 1.0 - torch.pow(torch.full_like(count, self.b2), count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        return _pairs(self.step(u, value)), {"mu": mu, "nu": nu, "count": count}
