"""Method comparison, port of `gpe_tpu/train/compare.py`: PL-PINN against the
vanilla PINN and the curriculum baseline under one budget
(`train_single_model`, `train_vanilla_checkpoints`, `train_curriculum_ramp`,
`compare_methods`), and the multi-seed statistical runner
(`train_multiple_runs`: success filtering, then median ± std).

Seeds: the net of seed s starts from `mlp.init_mlp` with a CPU
torch.Generator seeded s (`plpinn._generator`), so a seed gives the same
weights on every device. On the card every fit of an eligible spec goes
through the fused kernels: a single run through K1/K2, an ensemble
(`fit_ensemble`, the vanilla checkpoints and the seeds of
`train_multiple_runs`) through their run mode, K3; hard-BC specs train by
autograd, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.models.ansatz import box_sine_factor
from gpe_tpu_torch.models.mlp import stack_runs
from gpe_tpu_torch.train.loop import fit, fit_ensemble
from gpe_tpu_torch.train.optimizers import make_optimizer
from gpe_tpu_torch.train.plpinn import _generator, ramp_optimizer
from gpe_tpu_torch.train.pretrain import pretrain_to_base
from gpe_tpu_torch.train.problem import (GPESpec, base_triple, make_batch,
                                         make_fused_value_and_grad, make_loss_fn)
from gpe_tpu_torch.train.schedules import cosine_warm_restarts


class MethodRun(NamedTuple):
    mu: float
    best_loss: float
    epochs_run: int
    loss_history: np.ndarray
    mu_history: np.ndarray
    params: object


def _setup(spec: GPESpec, use_perturbation: bool, mode: int, device, mesh=None):
    """(spec, device, batch, loss_fn, fused vag or None) of one method, on
    the mesh's device under a mesh."""
    pin_full_f32()
    dev = resolve_device(device) if mesh is None else mesh.device
    spec = replace(spec, use_perturbation=use_perturbation)
    return (spec, dev, make_batch(spec, mode, device=dev), make_loss_fn(spec),
            make_fused_value_and_grad(spec, device=dev))


def _init(spec: GPESpec, seed: int, dev):
    return mlp.init_mlp(spec.layers, "xavier_uniform", generator=_generator(seed),
                        dtype=spec.dtype, device=dev)


def _pretrain_direct(spec: GPESpec, params, batch, mode: int, epochs: int):
    """Pretrain the COMPLETE direct solution to the mode's analytic base:
    the raw net, or net × sine factor for a hard-BC spec."""
    apply_fn = None
    if spec.hard_bc:
        factor = box_sine_factor(spec.lb, spec.ub)

        def apply_fn(p, x, act):
            return mlp.mlp_apply(p, x, act) * factor(x).value
    target = base_triple(spec, mode, batch["x"]).value
    return pretrain_to_base(params, batch["x"], target, spec.activation,
                            epochs=epochs, apply_fn=apply_fn)[0]


def _pretrain_perturbation(spec: GPESpec, params, batch, mode: int, epochs: int,
                           perturb_const: float):
    """Pretrain the raw net to the base; returns (params, q/normal_const)."""
    target = base_triple(spec, mode, batch["x"]).value
    params, _ = pretrain_to_base(params, batch["x"], target, spec.activation,
                                 epochs=epochs)
    with torch.no_grad():
        const = float(torch.max(mlp.mlp_apply(params, batch["x"], spec.activation)))
    return params, perturb_const / const


def train_single_model(spec: GPESpec, gamma: float, mode: int = 0,
                       use_perturbation: bool = True, epochs: int = 5001,
                       tol: float = 1e-5, patience: int = 2000,
                       perturb_const: float = 0.01, lr: float = 1e-3,
                       seed: int = 42, pretrain_epochs: int = 2000,
                       check_every: int = 512, mesh=None,
                       lr_mode: str = "loss_faithful", device=None) -> MethodRun:
    """One (method, γ, mode) training run with the reference budget, on
    `device` (None → the CUDA card). Both methods pretrain on the mode's
    analytic base: PL-PINN the raw net (then q-scaled), vanilla the complete
    solution (net × sine factor for a hard-BC spec). mesh (a "data" mesh):
    the fit with the collocation points sharded over its ranks, without the
    fused gradient (`fit(mesh=)`, as in the JAX package)."""
    spec, dev, batch, loss_fn, vag = _setup(spec, use_perturbation, mode, device,
                                            mesh)
    if mesh is not None:
        vag = None
    params = _init(spec, seed, dev)
    if use_perturbation:
        params, scale = _pretrain_perturbation(spec, params, batch, mode,
                                               pretrain_epochs, perturb_const)
    else:
        params, scale = _pretrain_direct(spec, params, batch, mode,
                                         pretrain_epochs), 1.0
    res = fit(loss_fn, ramp_optimizer(lr, lr_mode), params, batch, gamma, scale,
              epochs=epochs, tol=tol, patience=patience, check_every=check_every,
              value_and_grad_fn=vag, mesh=mesh)
    return MethodRun(res.mu_best, res.best_loss, res.epochs_run, res.loss_history,
                     res.mu_history, res.params)


def train_vanilla_checkpoints(spec: GPESpec, gammas, mode: int = 0,
                              epochs: int = 5001, tol: float = 1e-5,
                              patience: int = 2000, lr: float = 1e-3,
                              seed: int = 42, pretrain_epochs: int = 2000,
                              check_every: int = 512,
                              lr_mode: str = "loss_faithful",
                              device=None) -> dict:
    """The vanilla-PINN column of the comparison tables: one pretrain per
    mode and ONE fit_ensemble over the checkpoint γs (per-run γ), each run
    with `train_single_model(use_perturbation=False)`'s protocol. Returns
    {γ: mu_best}."""
    spec, dev, batch, loss_fn, vag = _setup(spec, False, mode, device)
    params = _pretrain_direct(spec, _init(spec, seed, dev), batch, mode,
                              pretrain_epochs)
    gs = [float(g) for g in gammas]
    pb = tuple((w.expand(len(gs), *w.shape).contiguous(),
                b.expand(len(gs), *b.shape).contiguous()) for w, b in params)
    res = fit_ensemble(loss_fn, ramp_optimizer(lr, lr_mode), pb, batch, gs, 1.0,
                       epochs=epochs, tol=tol, patience=patience,
                       check_every=check_every, value_and_grad_fn=vag)
    return {g: float(m) for g, m in zip(gs, res.mu_best)}


def train_curriculum_ramp(spec: GPESpec, gammas, mode: int = 0,
                          epochs: int = 5001, tol: float = 1e-5,
                          patience: int = 2000, lr: float = 1e-3,
                          seed: int = 42, pretrain_epochs: int = 2000,
                          check_every: int = 512,
                          lr_mode: str = "loss_faithful", device=None) -> dict:
    """The comparison tables' "Curriculum Training" baseline: a direct net
    (no perturbation ansatz) pretrained on the analytic base, then
    warm-started (restored best state) across the checkpoint γ ramp with the
    per-γ budget of the other methods; the ramp descends for the attractive
    family. Returns {γ: mu_best}."""
    spec, dev, batch, loss_fn, vag = _setup(spec, False, mode, device)
    params = _pretrain_direct(spec, _init(spec, seed, dev), batch, mode,
                              pretrain_epochs)
    opt = ramp_optimizer(lr, lr_mode)
    gs = [float(g) for g in gammas]
    gs = sorted(gs, reverse=all(g <= 0 for g in gs) and any(g < 0 for g in gs))
    out = {}
    for g in gs:
        res = fit(loss_fn, opt, params, batch, g, 1.0, epochs=epochs, tol=tol,
                  patience=patience, check_every=check_every,
                  value_and_grad_fn=vag)
        params = res.params
        out[g] = res.mu_best
    return out


def compare_methods(spec: GPESpec, gamma: float, mode: int = 0,
                    mu_ref: float | None = None, methods=("pl_pinn", "vanilla"),
                    **kwargs) -> dict:
    """Train each method with the same budget; per-method μ, best loss,
    epochs, loss history and, given mu_ref, the absolute and relative μ
    errors (the reference's paper_style_results table)."""
    out = {}
    for m in methods:
        run = train_single_model(spec, gamma, mode,
                                 use_perturbation=(m == "pl_pinn"), **kwargs)
        entry = {"mu": run.mu, "best_loss": run.best_loss,
                 "epochs": run.epochs_run, "loss_history": run.loss_history}
        if mu_ref is not None:
            entry["abs_error"] = abs(run.mu - mu_ref)
            entry["rel_error"] = abs(run.mu - mu_ref) / abs(mu_ref)
        out[m] = entry
    return out


def train_multiple_runs(spec: GPESpec, gamma: float, mode: int = 0,
                        n_runs: int = 5, base_seed: int = 42,
                        use_perturbation: bool = True, epochs: int = 5001,
                        tol: float = 1e-5, patience: int = 2000,
                        perturb_const: float = 0.01, lr: float = 1e-3,
                        pretrain_epochs: int = 2000, check_every: int = 512,
                        success_threshold: float | None = None,
                        mesh=None, device=None) -> dict:
    """Multi-seed statistical run (the reference protocol: seeds 42+i, each
    its own q-scale, success filtering with a fall-back to every run,
    median ± std). All seeds train as one ensemble: `fit_ensemble_packed`
    where the packed path takes the spec and seed count
    (`packed_runs_available`), else `fit_ensemble` with Adam on the cosine
    warm restarts, clip 1.0, per run. A vanilla run starts from its random
    init. mesh (an "ens" mesh): the seeds shard over its ranks through
    `fit_ensemble(mesh=)`, never the packed path (as in the JAX package)."""
    from gpe_tpu_torch.train.packed import fit_ensemble_packed, packed_runs_available

    spec, dev, batch, loss_fn, vag = _setup(spec, use_perturbation, mode, device,
                                            mesh)
    seeds = [base_seed + i for i in range(n_runs)]
    params_list, scales = [], []
    for s in seeds:
        p = _init(spec, s, dev)
        if use_perturbation:
            p, q = _pretrain_perturbation(spec, p, batch, mode, pretrain_epochs,
                                          perturb_const)
        else:
            q = 1.0
        params_list.append(p)
        scales.append(q)
    params_batch = stack_runs(params_list)
    if mesh is None and packed_runs_available(spec, n_runs, device=dev):
        ens = fit_ensemble_packed(spec, params_batch, batch, gamma, scales,
                                  epochs=epochs, tol=tol, patience=patience,
                                  check_every=check_every, lr=lr, lr_mode="cosine")
    else:
        opt = make_optimizer("adam", cosine_warm_restarts(lr, 200, 2, 1e-6),
                             clip_norm=1.0)
        ens = fit_ensemble(loss_fn, opt, params_batch, batch, gamma, scales,
                           epochs=epochs, tol=tol, patience=patience,
                           check_every=check_every, value_and_grad_fn=vag,
                           mesh=mesh)

    ok = np.ones(n_runs, dtype=bool)
    if success_threshold is not None:
        ok = ens.best_loss <= success_threshold
        if not ok.any():          # the reference falls back to all runs
            ok = np.ones(n_runs, dtype=bool)
    mus = ens.mu[ok]
    losses = ens.loss_history[ok]
    return {
        "mu_median": float(np.median(mus)),
        "mu_std": float(np.std(mus)),
        "mu_runs": ens.mu,
        "best_losses": ens.best_loss,
        "epochs_run": ens.epochs_run,
        "success_mask": ok,
        "loss_median": np.median(losses, axis=0),
        "loss_std": np.std(losses, axis=0),
        "seeds": seeds,
    }
