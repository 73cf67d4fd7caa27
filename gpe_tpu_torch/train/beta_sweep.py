"""Potential-strength (β) continuation sweeps, port of
`gpe_tpu/train/beta_sweep.py` (`BetaSweepResult`, `train_beta_sweep`).

- the β ramp sorted ascending, each rung warm-started from the previous
  rung's restored best state;
- PL-PINN ansatz: the RAW net pretrained to the analytic base of the unit
  potential once per mode (as the JAX package does, also for hard-BC
  specs), normal_const = max net(x), perturbation scale q/normal_const;
- per (mode, β): clip 1.0 → Adam on the warm-restart schedule of the
  update count, early stop (tol/patience), best-state restore;
- β scales the unit potential `batch["V"]` on the host, on a fresh copy of
  the batch per rung, so one loss function and one fused gradient serve
  the whole ramp. On a CUDA device every step of an eligible spec goes
  through the fused kernels (make_fused_value_and_grad).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.train.loop import fit
from gpe_tpu_torch.train.optimizers import make_optimizer
from gpe_tpu_torch.train.plpinn import _generator, _numpy_params
from gpe_tpu_torch.train.pretrain import pretrain_to_base
from gpe_tpu_torch.train.problem import (GPESpec, base_triple, make_batch,
                                         make_fused_value_and_grad, make_loss_fn)
from gpe_tpu_torch.train.schedules import cosine_warm_restarts


class BetaSweepResult(NamedTuple):
    params_by_mode: dict        # mode -> {beta: best params}
    mu_table: dict              # mode -> list[(beta, mu)]
    training_history: dict      # mode -> {beta: {"loss", "mu"}}
    constant_history: dict      # mode -> normal_const
    epochs_history: dict        # mode -> {beta: epochs_run}
    seconds: dict = None        # {"pretrain": {mode: s}, "fit": {mode: {beta: s}}}


def beta_scaled(batch: dict, beta: float) -> dict:
    """A copy of `batch` whose potential is β·V, β rounded to the
    potential's dtype and multiplied in it (the unit batch is untouched)."""
    out = dict(batch)
    out["V"] = batch["V"] * torch.tensor(beta, dtype=batch["V"].dtype,
                                         device=batch["V"].device)
    return out


def train_beta_sweep(spec: GPESpec, beta_values, gamma: float = 0.0,
                     modes=(0,), epochs: int = 5001, tol: float = 1e-5,
                     patience: int = 2000, perturb_const: float = 0.01,
                     lr: float = 1e-3, seed: int = 0,
                     pretrain_epochs: int = 2000, check_every: int = 512,
                     keep_params: bool = True, verbose: bool = False,
                     device=None) -> BetaSweepResult:
    """β-continuation sweep at fixed γ on `device` (None → the CUDA card).
    The spec's potential is the UNIT potential V(x); each β rung trains
    against β·V(x). The net of mode index mi starts from CPU generator seed
    `seed + 1000·mi`."""
    dev = resolve_device(device)
    pin_full_f32()
    beta_values = sorted(float(b) for b in beta_values)
    loss_fn = make_loss_fn(spec)
    fused_vag = make_fused_value_and_grad(spec, device=dev)

    params_by_mode, mu_table, training_history = {}, {}, {}
    constant_history, epochs_history = {}, {}
    seconds = {"pretrain": {}, "fit": {}}
    for mi, mode in enumerate(modes):
        batch0 = make_batch(spec, mode, device=dev)
        params = mlp.init_mlp(spec.layers, "xavier_uniform",
                              generator=_generator(seed + 1000 * mi),
                              dtype=spec.dtype, device=dev)
        if spec.use_perturbation:
            t0 = time.perf_counter()
            target = base_triple(spec, mode, batch0["x"]).value
            params, pre_mse = pretrain_to_base(params, batch0["x"], target,
                                               spec.activation,
                                               epochs=pretrain_epochs, lr=1e-3)
            with torch.no_grad():
                normal_const = float(torch.max(
                    mlp.mlp_apply(params, batch0["x"], spec.activation)))
            scale = perturb_const / normal_const
            seconds["pretrain"][mode] = time.perf_counter() - t0
            if verbose:
                print(f"mode {mode}: pretrain MSE {pre_mse:.3e} "
                      f"({seconds['pretrain'][mode]:.2f} s)")
        else:
            normal_const = 1.0
            scale = 1.0
        constant_history[mode] = normal_const

        mus, by_beta_params, by_beta_hist, by_beta_epochs = [], {}, {}, {}
        fit_s = seconds["fit"].setdefault(mode, {})
        optimizer = make_optimizer(
            "adam", cosine_warm_restarts(lr, T_0=200, T_mult=2, eta_min=1e-6),
            clip_norm=1.0)
        for beta in beta_values:
            t0 = time.perf_counter()
            res = fit(loss_fn, optimizer, params, beta_scaled(batch0, beta), gamma,
                      scale, epochs=epochs, tol=tol, patience=patience,
                      check_every=check_every, value_and_grad_fn=fused_vag)
            fit_s[beta] = time.perf_counter() - t0
            params = res.params          # warm start from the restored best state
            mus.append((beta, res.mu_best))
            if keep_params:
                by_beta_params[beta] = _numpy_params(res.params)
            by_beta_hist[beta] = {"loss": res.loss_history, "mu": res.mu_history}
            by_beta_epochs[beta] = res.epochs_run
            if verbose:
                print(f"mode {mode} β={beta:g}: μ={res.mu:.6f} "
                      f"loss={res.best_loss:.3e} epochs={res.epochs_run} "
                      f"({fit_s[beta]:.2f} s)")

        params_by_mode[mode] = by_beta_params
        mu_table[mode] = mus
        training_history[mode] = by_beta_hist
        epochs_history[mode] = by_beta_epochs

    return BetaSweepResult(params_by_mode, mu_table, training_history,
                           constant_history, epochs_history, seconds)
