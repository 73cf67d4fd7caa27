"""Curriculum / continuation trainer with stacked frozen-base mixing, port
of `gpe_tpu/train/curriculum.py`.

The interaction strength η ramps; at each step the complete solution is
ψ_k = ψ_{k−1} + α·net_k, ψ_{k−1} the frozen previous-η solution (the
analytic base at η = 0) and α(t) = 2 − β(t), β(t) = max(0.1, β₀·e^(−decay·t))
the α schedule `fit` steps through (`scale_schedule`). The collocation grid
is fixed, so the frozen stack folds into the batch's base arrays (value,
gradient, Laplacian, boundary value) after each η: every η trains against
base arrays, not a chain of frozen networks. The optimizer is any name of
the zoo (`make_optimizer`, clipped at 1.0); the loss trains by autograd,
as in the JAX package (no fused kernel).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from gpe_tpu_torch.device import resolve_device
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.train.loop import fit
from gpe_tpu_torch.train.optimizers import make_optimizer
from gpe_tpu_torch.train.problem import GPESpec, make_batch, make_loss_fn


class CurriculumResult(NamedTuple):
    params_by_eta: dict        # eta -> best params (numpy leaves)
    mu_table: list             # [(eta, mu)]
    history_by_eta: dict       # eta -> {"loss", "mu"}
    epochs_by_eta: dict
    seconds: dict = None       # eta -> seconds of its fit


def alpha_schedule(beta_init: float = 1.0, decay_rate: float = 1e-3,
                   floor: float = 0.1):
    """The reference's update_alpha_beta as a pure epoch → α function, in
    f32 arithmetic as the JAX package evaluates it."""
    f32 = np.float32

    def alpha(epoch):
        beta = np.maximum(f32(floor), f32(beta_init) * np.exp(f32(-decay_rate) * f32(epoch)))
        return f32(1.0) + (f32(1.0) - beta)
    return alpha


def train_curriculum(spec: GPESpec, eta_values, mode: int = 0,
                     epochs: int = 3000, lr: float = 1e-3, seed: int = 0,
                     beta_init: float = 1.0, decay_rate: float = 1e-3,
                     tol: float = 0.0, patience: int = 10**9,
                     check_every: int = 512, fresh_net_per_eta: bool = True,
                     optimizer: str = "adam", verbose: bool = False,
                     device=None) -> CurriculumResult:
    """η-ramp continuation with frozen-previous-solution stacking on
    `device` (None → the CUDA card). Fresh nets come from one CPU
    torch.Generator seeded by `seed`, one draw per η."""
    if not spec.use_perturbation:
        raise ValueError("curriculum training stacks on a base; "
                         "spec.use_perturbation must be True")
    dev = resolve_device(device)
    eta_values = sorted(float(e) for e in eta_values)
    loss_fn = make_loss_fn(spec)
    batch = dict(make_batch(spec, mode, device=dev))
    sched = alpha_schedule(beta_init, decay_rate)
    generator = torch.Generator().manual_seed(seed)

    def fresh():
        return mlp.init_mlp(spec.layers, "xavier_uniform", generator=generator,
                            dtype=spec.dtype, device=dev)

    params = fresh()
    params_by_eta, mu_table, hist, eps, seconds = {}, [], {}, {}, {}
    for k, eta in enumerate(eta_values):
        if fresh_net_per_eta and k > 0:
            params = fresh()
        opt = make_optimizer(optimizer, lr, clip_norm=1.0)
        t0 = time.perf_counter()
        res = fit(loss_fn, opt, params, batch, eta, 1.0, epochs=epochs, tol=tol,
                  patience=patience, check_every=check_every, scale_schedule=sched)
        seconds[eta] = time.perf_counter() - t0
        params = res.params
        mu_table.append((eta, res.mu_best))
        params_by_eta[eta] = tuple((w.cpu().numpy(), b.cpu().numpy()) for w, b in res.params)
        hist[eta] = {"loss": res.loss_history, "mu": res.mu_history}
        eps[eta] = res.epochs_run
        if verbose:
            print(f"η={eta:g}: μ={res.mu:.6f} loss={res.best_loss:.3e}", flush=True)

        # freeze ψ_k = base + α(epochs_run)·net_k into the next η's base arrays
        alpha_final = float(sched(res.epochs_run))
        with torch.no_grad():
            n = mlp.mlp_vgl(res.params, batch["x"], spec.activation)
            batch["base_val"] = batch["base_val"] + alpha_final * n.value
            batch["base_grad"] = batch["base_grad"] + alpha_final * n.grad
            batch["base_lap"] = batch["base_lap"] + alpha_final * n.lap
            nb = mlp.mlp_apply(res.params, batch["bx"], spec.activation)
            batch["base_bval"] = batch["base_bval"] + alpha_final * nb
    return CurriculumResult(params_by_eta, mu_table, hist, eps, seconds)
