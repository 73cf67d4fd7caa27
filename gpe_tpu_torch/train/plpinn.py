"""PL-PINN continuation training, port of `gpe_tpu/train/plpinn.py`
(`train_plpinn`, `_rebase`, `ramp_optimizer`).

Per mode: pretrain the raw net on the analytic base (γ = 0 start), capture
normal_const = max net(x) and scale the perturbation by q/normal_const; then
for each γ of the sorted ramp fit() with clipped Adam and early stop,
restore the best state and warm-start the next γ. rebase=True folds the
converged perturbation into the base after each γ; lm_polish=True runs a
Levenberg–Marquardt polish at the final γ. On a CUDA device every fit step
goes through the fused kernels (make_fused_value_and_grad).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.train.loop import fit
from gpe_tpu_torch.train.optimizers import ClipAdam
from gpe_tpu_torch.train.pretrain import pretrain_to_base
from gpe_tpu_torch.train.problem import (GPESpec, spec_ansatz, base_triple,
                                         make_batch, make_fused_value_and_grad,
                                         make_loss_fn)
from gpe_tpu_torch.train.schedules import cosine_warm_restarts, scale_by_loss_as_step


def ramp_optimizer(lr: float = 1e-3, lr_mode: str = "loss_faithful"):
    """The continuation-ramp optimizer in the reference's effective LR
    behaviour ("loss_faithful"): global-norm clip 1.0, Adam, and the
    warm-restart schedule (T₀=200, T_mult=2) evaluated at the current loss."""
    if lr_mode != "loss_faithful":
        raise NotImplementedError(
            f"lr_mode={lr_mode!r} is not ported yet; see "
            "gpe_tpu.train.plpinn.ramp_optimizer")
    sched = cosine_warm_restarts(lr, T_0=200, T_mult=2, eta_min=1e-6)
    return ClipAdam(scale_by_loss_as_step(sched), clip=1.0)


class PLPINNResult(NamedTuple):
    params_by_mode: dict        # mode -> {gamma: params (best state)}
    mu_table: dict              # mode -> list[(gamma, mu)]
    training_history: dict      # mode -> {gamma: {"loss", "mu"}}
    constant_history: dict      # mode -> normal_const
    epochs_history: dict        # mode -> {gamma: epochs_run}
    polished: dict = None       # mode -> {"gamma", "mu", "steps", ...}


def _rebase(spec: GPESpec, batch: dict, params, scale: float,
            generator: torch.Generator) -> tuple:
    """Fold the current perturbation into the base arrays and reset the
    output layer to a tiny random map (1e-3·N(0,1) from `generator`; an
    exactly-zero last layer would zero the Jacobian w.r.t. every hidden
    param), keeping the hidden features as a warm start."""
    a = spec_ansatz(spec)
    with torch.no_grad():
        n = a.vgl(params, batch["x"], 1.0)
        batch = dict(batch)
        batch["base_val"] = batch["base_val"] + scale * n.value
        batch["base_grad"] = batch["base_grad"] + scale * n.grad
        batch["base_lap"] = batch["base_lap"] + scale * n.lap
        batch["base_bval"] = batch["base_bval"] + scale * a.value(params, batch["bx"], 1.0)
    w_last, b_last = params[-1]
    w_new = 1e-3 * torch.randn(w_last.shape, generator=generator,
                               dtype=torch.float64)
    params = tuple(params[:-1]) + ((w_new.to(w_last), torch.zeros_like(b_last)),)
    return batch, params


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def train_plpinn(spec: GPESpec, gamma_values, modes=(0,), epochs: int = 5001,
                 tol: float = 1e-5, patience: int = 2000,
                 perturb_const: float = 0.01, lr: float = 1e-3, seed: int = 0,
                 pretrain_epochs: int = 2000, check_every: int = 512,
                 keep_params: bool = True, rebase: bool = False,
                 checkpoint_path: str | None = None, mesh=None,
                 lr_mode: str = "loss_faithful", lm_polish: bool = False,
                 lm_steps: int = 120, lm_cg_iters: int = 80,
                 polish_checkpoints=(), polish_x64: bool = False,
                 verbose: bool = False, device=None) -> PLPINNResult:
    """Run the PL-PINN continuation sweep on `device` (None → the CUDA
    card). Seeds: the net of mode index mi starts from CPU generator seed
    `seed + 1000·mi`; the rebase after γ index gi draws from
    `(seed + 1000·mi)·1_000_003 + gi`."""
    for name, unported in (("checkpoint_path", checkpoint_path),
                           ("mesh", mesh),
                           ("polish_checkpoints", tuple(polish_checkpoints)),
                           ("polish_x64", polish_x64)):
        if unported:
            raise NotImplementedError(
                f"{name} is not ported yet; see gpe_tpu.train.plpinn.train_plpinn")
    dev = resolve_device(device)
    pin_full_f32()
    gs = [float(g) for g in gamma_values]
    gamma_values = sorted(gs, reverse=all(g <= 0 for g in gs) and any(g < 0 for g in gs))
    loss_fn = make_loss_fn(spec)
    fused_vag = make_fused_value_and_grad(spec, device=dev)

    params_by_mode, mu_table, training_history = {}, {}, {}
    constant_history, epochs_history, polished = {}, {}, {}
    for mi, mode in enumerate(modes):
        batch = make_batch(spec, mode, device=dev)
        mode_seed = seed + 1000 * mi
        params = mlp.init_mlp(spec.layers, "xavier_uniform",
                              generator=_generator(mode_seed), dtype=spec.dtype,
                              device=dev)
        if spec.use_perturbation:
            target = base_triple(spec, mode, batch["x"]).value
            params, pre_mse = pretrain_to_base(params, batch["x"], target,
                                               spec.activation,
                                               epochs=pretrain_epochs, lr=1e-3)
            if verbose:
                print(f"mode {mode}: pretrain MSE {pre_mse:.3e}")
            with torch.no_grad():
                normal_const = float(torch.max(
                    mlp.mlp_apply(params, batch["x"], spec.activation)))
            scale = perturb_const / normal_const
        else:
            normal_const = 1.0
            scale = 1.0
        constant_history[mode] = normal_const

        mus, by_gamma_params, by_gamma_hist, by_gamma_epochs = [], {}, {}, {}
        optimizer = ramp_optimizer(lr, lr_mode)
        for gi, gamma in enumerate(gamma_values):
            res = fit(loss_fn, optimizer, params, batch, gamma, scale,
                      epochs=epochs, tol=tol, patience=patience,
                      check_every=check_every, value_and_grad_fn=fused_vag)
            params = res.params
            mus.append((gamma, res.mu_best))
            if keep_params:
                by_gamma_params[gamma] = tuple(
                    (w.cpu().numpy(), b.cpu().numpy()) for w, b in res.params)
            by_gamma_hist[gamma] = {"loss": res.loss_history, "mu": res.mu_history}
            by_gamma_epochs[gamma] = res.epochs_run
            if verbose:
                print(f"mode {mode} γ={gamma:g}: μ={res.mu:.6f} "
                      f"loss={res.best_loss:.3e} epochs={res.epochs_run}")
            if rebase:
                batch, params = _rebase(spec, batch, params, scale,
                                        _generator(mode_seed * 1_000_003 + gi))

        params_by_mode[mode] = by_gamma_params
        mu_table[mode] = mus
        training_history[mode] = by_gamma_hist
        epochs_history[mode] = by_gamma_epochs

        if lm_polish and mus:
            from gpe_tpu_torch.train.gauss_newton import (make_gpe_residual_fn,
                                                          make_lm_solver)
            lm = make_lm_solver(make_gpe_residual_fn(spec), params,
                                steps=lm_steps, cg_iters=lm_cg_iters)
            g_last = mus[-1][0]
            res_lm = lm(params, batch, g_last, scale)
            with torch.no_grad():
                _, aux_lm = loss_fn(res_lm.params, batch, g_last, scale)
            entry = polished.setdefault(mode, {})
            entry.update({"gamma": g_last, "mu": float(aux_lm["mu"]),
                          "steps": lm_steps})
            if keep_params:
                entry["params"] = tuple((w.cpu().numpy(), b.cpu().numpy())
                                        for w, b in res_lm.params)
                entry["scale"] = float(scale)
                if "base_val" in batch:
                    entry["base_val"] = batch["base_val"].cpu().numpy()
            if verbose:
                print(f"mode {mode} γ={g_last:g}: LM-polished μ={entry['mu']:.7f}")

    return PLPINNResult(params_by_mode, mu_table, training_history,
                        constant_history, epochs_history, polished)
