"""Training loop with the reference's early-stop semantics, port of
`gpe_tpu/train/loop.py:fit`.

- a gradient step each epoch (scheduler inside the optimizer);
- the best-loss params are tracked and RESTORED at the end;
- early stop when the total loss ≤ tol or no improvement for `patience`.

Everything the loop carries — params, optimizer state, best params, best
loss, patience counter, done flag, stop epoch — stays on the device. The
host reads the done flag and the loss/μ histories once per `check_every`
chunk, never per step; steps after an early stop inside a chunk are masked
(computed, not applied), as in the JAX scan. Params are any tree of tensors
(the MLP's (W, b) pairs, or the self-adaptive {"net", "log_alpha"}).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from gpe_tpu_torch.device import pin_full_f32


class FitResult(NamedTuple):
    params: Any                # best params (restored)
    final_params: Any          # last-iterate params (for warm starts)
    best_loss: float
    mu: float                  # μ at the final recorded epoch
    epochs_run: int
    loss_history: np.ndarray
    mu_history: np.ndarray
    mu_best: float = 0.0       # μ evaluated at the restored best params


class EnsembleFitResult(NamedTuple):
    params: Any                # best params, leading axis = run
    final_params: Any
    best_loss: np.ndarray      # (R,)
    mu: np.ndarray             # (R,) μ at last epoch
    epochs_run: np.ndarray     # (R,)
    loss_history: np.ndarray   # (R, T)
    mu_history: np.ndarray     # (R, T)
    mu_best: np.ndarray = None  # (R,) μ at the restored best params


def value_and_grad(loss_fn: Callable) -> Callable:
    """vag(params, batch, gamma, scale) -> ((total, aux), grads) by autograd
    — the twin of jax.value_and_grad(loss_fn, has_aux=True); params is any
    tree of tensors, grads has its structure."""
    def vag(params, batch, gamma, scale):
        leaves, spec = pytree.tree_flatten(params)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            total, aux = loss_fn(pytree.tree_unflatten(leaves, spec), batch,
                                 gamma, scale)
            grads = torch.autograd.grad(total, leaves)
        aux = {k: v.detach() for k, v in aux.items()}
        return (total.detach(), aux), pytree.tree_unflatten(list(grads), spec)
    return vag


def _where(cond, a, b):
    return pytree.tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def _as_device_scalar(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def fit(loss_fn: Callable, optimizer, params, batch, gamma, scale,
        epochs: int = 5001, tol: float = 1e-5, patience: int = 2000,
        check_every: int = 512, value_and_grad_fn: Callable = None) -> FitResult:
    """Train until convergence or `epochs`, reference early-stop semantics.

    loss_fn(params, batch, gamma, scale) -> (total, aux with 'mu').
    `value_and_grad_fn` (the contract of `value_and_grad(loss_fn)`) swaps in
    a custom gradient, e.g. the fused CUDA kernels; a stateful one
    (`.stateful`, `.init_state`) is initialised here and threaded through
    the steps. `optimizer` has init(params) / update(grads, state, value)."""
    pin_full_f32()
    dev = batch["x"].device
    gamma = _as_device_scalar(gamma, dev)
    scale = _as_device_scalar(scale, dev)
    check_every = min(check_every, epochs)
    vag = value_and_grad_fn or value_and_grad(loss_fn)
    stateful = bool(getattr(vag, "stateful", False))
    vstate = vag.init_state(params, batch, gamma, scale) if stateful else None

    opt_state = optimizer.init(params)
    best_params = params
    best_loss = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    since = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    stop_epoch = torch.full((), epochs, dtype=torch.int64, device=dev)

    losses, mus = [], []
    steps_done = 0
    while steps_done < epochs:
        n = min(check_every, epochs - steps_done)
        l_hist, mu_hist = [], []
        for i in range(n):
            if stateful:
                (loss, aux), grads, vstate = vag(params, batch, gamma, scale, vstate)
            else:
                (loss, aux), grads = vag(params, batch, gamma, scale)
            updates, opt_state = optimizer.update(grads, opt_state, loss)
            new_params = pytree.tree_map(torch.add, params, updates)
            improved = (loss < best_loss) & ~done
            best_loss = torch.where(improved, loss, best_loss)
            best_params = _where(improved, params, best_params)
            since = torch.where(improved, torch.zeros_like(since), since + 1)
            now_done = (loss <= tol) | (since >= patience)
            stop_epoch = torch.where(done | ~now_done, stop_epoch,
                                     torch.full_like(stop_epoch, steps_done + i))
            params = _where(done, params, new_params)
            done = done | now_done
            l_hist.append(loss)
            mu_hist.append(aux["mu"])
        losses.append(torch.stack(l_hist).cpu().numpy())
        mus.append(torch.stack(mu_hist).cpu().numpy())
        steps_done += n
        if bool(done):
            break

    loss_history = np.concatenate(losses) if losses else np.zeros((0,))
    mu_history = np.concatenate(mus) if mus else np.zeros((0,))
    epochs_run = min(int(stop_epoch), epochs) if bool(done) else steps_done
    loss_history = loss_history[: max(epochs_run, 1)]
    mu_history = mu_history[: max(epochs_run, 1)]
    with torch.no_grad():
        _, aux_best = loss_fn(best_params, batch, gamma, scale)
    return FitResult(
        params=best_params,
        final_params=params,
        best_loss=float(best_loss),
        mu=float(mu_history[-1]) if mu_history.size else 0.0,
        epochs_run=epochs_run,
        loss_history=loss_history,
        mu_history=mu_history,
        mu_best=float(aux_best["mu"]),
    )
