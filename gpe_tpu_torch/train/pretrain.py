"""Analytic-solution pretraining, port of `gpe_tpu/train/pretrain.py`
(`pretrain_to_base`, `pretrain_sobolev`): fit the net to a target by Adam
(optax.adam's arithmetic, `optimizers.scale_by_adam`), then by optax's
L-BFGS with its zoom line search (`train/lbfgs.py:lbfgs()`: memory 10, no
learning rate), exactly `lbfgs_steps` steps, each reusing the last line
search's value and gradient as `optax.value_and_grad_from_state` does. The
MSE returned is JAX's `losses[-1]`: the loss at the start of the last step
of the last phase that ran. On a CUDA device the Adam steps replay a CUDA
graph of one step: the same kernels, without the host's cost of launching
each.

`run_lbfgs.steps` counts the L-BFGS steps run (by both functions), the
way the kernel wrappers count their launches.
"""
from __future__ import annotations

import numpy as np
import torch

from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.train.lbfgs import last_value_and_grad, lbfgs, value_and_grad_of
from gpe_tpu_torch.train.optimizers import adam_init, scale_by_adam


def _pairs(leaves):
    return tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))


def _leaves(params):
    return [t.detach().clone().requires_grad_(True) for pair in params for t in pair]


def pretrain_to_base(params, x, target, activation: str = "shifted_tanh",
                     epochs: int = 2000, lr: float = 1e-3,
                     lbfgs_steps: int = 50, tol: float = 1e-12, apply_fn=None):
    """Returns (params, final_mse). `lbfgs_steps` L-BFGS steps follow the
    Adam phase unless its last step's MSE is already ≤ tol. `apply_fn(params,
    x, activation)` replaces the raw net's output: a hard-BC spec pretrains
    the complete solution, net × sine factor, to the base."""
    pin_full_f32()
    leaves = _leaves(params)
    apply = apply_fn or mlp.mlp_apply

    def mse(ls):
        return torch.mean((apply(_pairs(ls), x, activation) - target) ** 2)

    last = AdamSteps(lambda: mse(leaves), leaves, lr, leaves[0].is_cuda).run(epochs)
    with torch.no_grad():
        final = float(mse(leaves) if last is None else last)
    if final > tol and lbfgs_steps > 0:
        leaves, losses = run_lbfgs(mse, [t.detach() for t in leaves], lbfgs_steps)
        final = losses[-1]
    return tuple((w.detach(), b.detach()) for w, b in _pairs(leaves)), final


def _sobolev_loss(x, tval, tjac, activation: str, jac_weight: float):
    """mean (value − target)² + jac_weight · mean (∇ − target ∇)², the net's
    value and gradient from one forward-Laplacian pass (`mlp_vgl`; jac
    layout (N, d, out))."""
    def loss(ls):
        n = mlp.mlp_vgl(_pairs(ls), x, activation)
        val = n.value if n.value.ndim == tval.ndim else n.value[:, None]
        jac = n.grad if n.grad.ndim == tjac.ndim else n.grad[..., None]
        return torch.mean((val - tval) ** 2) + jac_weight * torch.mean((jac - tjac) ** 2)
    return loss


def pretrain_sobolev(params, x, target_val, target_jac, activation: str = "tanh",
                     epochs: int = 4000, lr: float = 1e-3, lbfgs_steps: int = 200,
                     jac_weight: float = 0.1):
    """Sobolev (H¹) distillation: fit the net's values and first
    derivatives to a target field, Adam for `epochs` steps, then
    `lbfgs_steps` L-BFGS steps (no tol gate, as in JAX). target_val (N,)
    or (N, out); target_jac (N, d, out) — the mlp_vgl jac layout. Returns
    (params, final loss)."""
    pin_full_f32()
    leaves = _leaves(params)
    as_f32 = lambda a: (a.to(device=x.device, dtype=torch.float32) if torch.is_tensor(a)
                        else torch.tensor(np.asarray(a, np.float32), device=x.device))
    loss = _sobolev_loss(x, as_f32(target_val), as_f32(target_jac), activation,
                         jac_weight)
    last = AdamSteps(lambda: loss(leaves), leaves, lr, leaves[0].is_cuda).run(epochs)
    with torch.no_grad():
        final = float(loss(leaves) if last is None else last)
    if lbfgs_steps > 0:
        leaves, losses = run_lbfgs(loss, [t.detach() for t in leaves], lbfgs_steps)
        final = losses[-1]
    return tuple((w.detach(), b.detach()) for w, b in _pairs(leaves)), final


def run_lbfgs(obj, leaves, steps: int):
    """`steps` steps of optax.lbfgs() on obj(leaf list): (the leaves after
    the last step, the loss before each step as host floats)."""
    opt = lbfgs()
    state = opt.init(leaves)
    losses = []
    for _ in range(steps):
        last = last_value_and_grad(opt, state)
        if last is None:
            value, g = value_and_grad_of(obj, leaves)
            value = value.item()
        else:
            value, g = last
        updates, state = opt.update(list(g), state, leaves, value=value, obj_fn=obj)
        leaves = [p + u for p, u in zip(leaves, updates)]
        losses.append(value)
        run_lbfgs.steps += 1
    return leaves, losses


run_lbfgs.steps = 0


class AdamSteps:
    """Adam steps (optax.adam's arithmetic) on `leaves`, in place, with one
    Adam state across calls of `run`. graph=True (a CUDA device): the first
    two steps launched op by op (on a side stream, outside the capture),
    then a CUDA graph of one step, captured once and replayed for every
    later step. `loss()` reads the leaves and whatever buffers it closes
    over, so a caller may refill a captured buffer between calls."""

    def __init__(self, loss, leaves, lr: float, graph: bool):
        self.loss, self.leaves, self.lr, self.graph = loss, leaves, lr, graph
        self.state = adam_init(leaves)
        # optax.adam's bias correction runs in the params' float type (f64
        # under x64); the count starts at 0 either way
        self.state["count"] = self.state["count"].to(leaves[0].dtype)
        self.last = torch.zeros((), dtype=leaves[0].dtype, device=leaves[0].device)
        self.eager_steps, self.cuda_graph = 0, None

    def _step(self):
        with torch.enable_grad():
            value = self.loss()
            g = torch.autograd.grad(value, self.leaves)
        u, new = scale_by_adam(list(g), self.state)
        with torch.no_grad():
            torch._foreach_add_(self.leaves, torch._foreach_mul(u, -self.lr))
            for k in ("mu", "nu"):
                torch._foreach_copy_(self.state[k], new[k])
            self.state["count"].copy_(new["count"])
            self.last.copy_(value)

    def run(self, steps: int):
        """`steps` more steps; returns the loss of the last one, before its
        update (a 0-d device tensor, overwritten by the next call; None
        for no step)."""
        if steps <= 0:
            return None
        if not self.graph:
            for _ in range(steps):
                self._step()
            return self.last
        dev = self.leaves[0].device
        warm = min(steps, 2 - self.eager_steps) if self.cuda_graph is None else 0
        if warm > 0:
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(warm):
                    self._step()
            main.wait_stream(side)
            self.eager_steps += warm
        if steps > warm:
            if self.cuda_graph is None:
                self.cuda_graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.cuda_graph):
                    self._step()
            for _ in range(steps - warm):
                self.cuda_graph.replay()
        return self.last

