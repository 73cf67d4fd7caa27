"""ReLoBRaLo-balanced training, port of `gpe_tpu/train/balanced.py`
(`BalancedFitResult`, `fit_relobralo`).

Every step: the loss terms from one evaluation, the balancing weights λ
from their DETACHED values (`losses/balancing.py:relobralo_step`, the
lookback drawn from a generator seeded from `seed`), the total
Σ λ·manual·L with λ held constant in the backward pass, then one
optimizer step. No early stop and no best-state restore, as in the JAX
scan; the histories are read from the device once, at the end.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.losses.balancing import relobralo_init, relobralo_step
from gpe_tpu_torch.train.optimizers import make_optimizer
from gpe_tpu_torch.train.problem import GPESpec, make_terms_fn


class BalancedFitResult(NamedTuple):
    params: Any
    mu: float
    best_loss: float
    loss_history: np.ndarray       # (T,) weighted total
    mu_history: np.ndarray         # (T,)
    lambda_history: np.ndarray     # (T, n_terms) balancing weights
    term_names: tuple


def fit_relobralo(spec: GPESpec, params, batch, gamma, scale=1.0,
                  epochs: int = 3000, lr: float = 1e-3, seed: int = 0,
                  manual_weights: dict | None = None, alpha: float = 0.999,
                  temperature: float = 0.1, rho: float = 0.999,
                  optimizer=None) -> BalancedFitResult:
    """Train a GPE PINN with ReLoBRaLo loss balancing on the device of
    `batch`.

    manual_weights: name -> multiplier applied on top of the balancing λ
    (defaults to spec.loss_weights(), the reference's manual × λ product).
    optimizer: init(params) / update(grads, state, value), default a
    global-norm clip 1.0 then Adam(lr). μ is the last step's, best_loss
    the least total of the run."""
    pin_full_f32()
    terms_fn = make_terms_fn(spec)
    weights = dict(spec.loss_weights())
    if manual_weights:
        weights.update(manual_weights)
    names = tuple(sorted(weights))
    dev = batch["x"].device
    manual_w = torch.tensor([weights[k] for k in names], dtype=torch.float32,
                            device=dev)
    gamma = torch.tensor(float(gamma), dtype=torch.float32, device=dev)
    scale = torch.tensor(float(scale), dtype=torch.float32, device=dev)

    optimizer = optimizer or make_optimizer("adam", lr, clip_norm=1.0)
    opt_state = optimizer.init(params)
    state = relobralo_init(len(names), device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)

    totals, mus, lams = [], [], []
    for _ in range(epochs):
        leaves, tree = pytree.tree_flatten(params)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            out = terms_fn(pytree.tree_unflatten(leaves, tree), batch, gamma, scale)
            lvec = torch.stack([out.losses[k] for k in names])
            lam, state = relobralo_step(state, lvec.detach(), generator, alpha=alpha,
                                        temperature=temperature, rho=rho)
            total = torch.sum(lam * manual_w * lvec)
            grads = torch.autograd.grad(total, leaves)
        updates, opt_state = optimizer.update(
            pytree.tree_unflatten(list(grads), tree), opt_state, params,
            value=total.detach())
        params = pytree.tree_map(torch.add, params, updates)
        totals.append(total.detach())
        mus.append(out.mu.detach())
        lams.append(lam)

    totals = torch.stack(totals).cpu().numpy()
    mus = torch.stack(mus).cpu().numpy()
    return BalancedFitResult(
        params=pytree.tree_map(torch.Tensor.detach, params), mu=float(mus[-1]),
        best_loss=float(totals.min()), loss_history=totals, mu_history=mus,
        lambda_history=torch.stack(lams).cpu().numpy(), term_names=names)
