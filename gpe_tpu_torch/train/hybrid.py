"""Hybrid Adam → L-BFGS trainer, port of `gpe_tpu/train/hybrid.py`.

The Adam phase is `fit`; the L-BFGS phase is the port of optax's
`lbfgs()` (train/lbfgs.py: memory 10, zoom line search, no learning
rate), each step reusing the line search's last value and gradient as
`optax.value_and_grad_from_state` does, and the best iterate seen is
kept (the line search can end on an uphill step).
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.train.lbfgs import last_value_and_grad, lbfgs, value_and_grad_of
from gpe_tpu_torch.train.loop import FitResult, _as_device_f32, fit
from gpe_tpu_torch.train.optimizers import make_optimizer


class HybridResult(NamedTuple):
    params: any
    adam: FitResult
    lbfgs_losses: np.ndarray
    mu: float
    seconds: dict = None       # {"adam", "lbfgs"}


def _lbfgs_fit(loss_fn, params, batch, gamma, scale, steps: int):
    """`steps` L-BFGS steps from `params`: (the best iterate seen, or the
    last when it is no worse; the loss before each step)."""
    opt = lbfgs()
    leaves, spec = pytree.tree_flatten(params)
    obj = lambda p: loss_fn(p, batch, gamma, scale)[0]
    flat = lambda ls: obj(pytree.tree_unflatten(ls, spec))
    state = opt.init(params)
    best, best_loss, losses = params, float("inf"), []
    for _ in range(steps):
        last = last_value_and_grad(opt, state)
        if last is None:
            value, g = value_and_grad_of(flat, pytree.tree_leaves(params))
            value = value.item()
        else:
            value, g = last
        updates, state = opt.update(pytree.tree_unflatten(g, spec), state, params,
                                    value=value, obj_fn=obj)
        if value < best_loss:
            best, best_loss = params, value
        losses.append(value)
        params = pytree.tree_map(torch.add, params, updates)
    last = last_value_and_grad(opt, state)
    final = last[0] if last is not None else float(obj(params))
    dtype = np.dtype(str(leaves[0].dtype).replace("torch.", ""))
    return (params if final <= best_loss else best), np.asarray(losses, dtype)


def fit_hybrid(loss_fn: Callable, params, batch, gamma, scale,
               adam_epochs: int = 1000, adam_lr: float = 1e-3,
               lbfgs_steps: int = 500, clip_norm: float = 10.0,
               tol: float = 0.0, patience: int = 10**9,
               check_every: int = 512) -> HybridResult:
    """Adam warm phase (clipped at clip_norm), then L-BFGS from its last
    iterate. Returns the params, both phases' loss histories and μ at the
    final params."""
    pin_full_f32()
    dev = batch["x"].device
    gamma = _as_device_f32(gamma, dev)
    scale = _as_device_f32(scale, dev)
    opt = make_optimizer("adam", adam_lr, clip_norm=clip_norm)
    t0 = time.perf_counter()
    adam_res = fit(loss_fn, opt, params, batch, gamma, scale, epochs=adam_epochs,
                   tol=tol, patience=patience, check_every=check_every)
    seconds = {"adam": time.perf_counter() - t0}
    params = adam_res.final_params
    t0 = time.perf_counter()
    if lbfgs_steps > 0:
        params, lbfgs_losses = _lbfgs_fit(loss_fn, params, batch, gamma, scale,
                                          lbfgs_steps)
    else:
        lbfgs_losses = np.zeros((0,))
    seconds["lbfgs"] = time.perf_counter() - t0
    with torch.no_grad():
        mu = float(loss_fn(params, batch, gamma, scale)[1]["mu"])
    return HybridResult(params, adam_res, lbfgs_losses, mu, seconds)
