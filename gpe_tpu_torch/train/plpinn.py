"""PL-PINN continuation training, port of `gpe_tpu/train/plpinn.py`
(`train_plpinn`, `_rebase`, `ramp_optimizer` with all its lr modes).

Per mode: pretrain the raw net on the analytic base (γ = 0 start), capture
normal_const = max net(x) and scale the perturbation by q/normal_const; then
for each γ of the sorted ramp fit() with clipped Adam and early stop,
restore the best state and warm-start the next γ. rebase=True folds the
converged perturbation into the base after each γ; lm_polish=True runs a
Levenberg–Marquardt polish at the final γ; checkpoint_path, polish_checkpoints
and polish_x64 as in the JAX package. On a CUDA device every fit step goes
through the fused kernels (make_fused_value_and_grad).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.train.loop import fit
from gpe_tpu_torch.train.optimizers import ClipAdam, make_optimizer
from gpe_tpu_torch.train.pretrain import pretrain_to_base
from gpe_tpu_torch.train.problem import (GPESpec, spec_ansatz, base_triple,
                                         make_batch, make_fused_value_and_grad,
                                         make_loss_fn)
from gpe_tpu_torch.train.schedules import cosine_warm_restarts


def _warmup(count):
    """The 200-step linear warmup factor min(1, count/200)."""
    return torch.clamp(count / 200.0, max=1.0)


def ramp_optimizer(lr: float = 1e-3, lr_mode: str = "loss_faithful"):
    """The continuation-ramp optimizer: global-norm clip 1.0, Adam, and the
    LR of `lr_mode`, as the JAX package's optax chains compute it:

    - "loss_faithful" (default): the reference's effective LR, the
      warm-restart schedule (T₀=200, T_mult=2) evaluated at the current loss;
    - "cosine": that schedule over the update count (the one the reference
      authored);
    - "constant": lr;
    - "warmup_faithful": loss_faithful × min(1, count/200);
    - "warmup_cosine": cosine × min(1, count/200).

    The count is optax's schedule count, the updates before this one: the
    warmup modes' first update is scaled by 0. The ensemble trainers take
    its `per_run_form()`: clip and loss-as-step LR per run."""
    sched = cosine_warm_restarts(lr, T_0=200, T_mult=2, eta_min=1e-6)
    at_loss = lambda loss: -sched(loss)
    if lr_mode == "loss_faithful":
        return ClipAdam(at_loss, clip=1.0)
    if lr_mode == "cosine":
        return make_optimizer("adam", sched, clip_norm=1.0)
    if lr_mode == "constant":
        return make_optimizer("adam", lr, clip_norm=1.0)
    if lr_mode == "warmup_faithful":
        return ClipAdam(at_loss, clip=1.0, count_scale=_warmup)
    if lr_mode == "warmup_cosine":
        return ClipAdam(clip=1.0, count_scale=lambda c: -(sched(c) * _warmup(c)))
    raise ValueError(f"unknown lr_mode {lr_mode!r}")


class PLPINNResult(NamedTuple):
    params_by_mode: dict        # mode -> {gamma: params (best state)}
    mu_table: dict              # mode -> list[(gamma, mu)]
    training_history: dict      # mode -> {gamma: {"loss", "mu"}}
    constant_history: dict      # mode -> normal_const
    epochs_history: dict        # mode -> {gamma: epochs_run}
    polished: dict = None       # mode -> {"gamma", "mu", "steps", ...}
    seconds: dict = None        # {"pretrain": {mode: s}, "fit": {mode: {gamma: s}},
    #                              "lm": {mode: s}}: host wall time of each part


def _rebase(spec: GPESpec, batch: dict, params, scale: float,
            generator: torch.Generator) -> tuple:
    """Fold the current perturbation into the base arrays (the reflected
    base too, under a symmetry) and reset the output layer to a tiny random
    map (1e-3·N(0,1) from `generator`; an exactly-zero last layer would
    zero the Jacobian w.r.t. every hidden param), keeping the hidden
    features as a warm start. The fold goes through the loss's own ansatz
    (the hard-BC sine factor included): folding the raw net under a hard-BC
    spec rebases onto a function the loss never saw, and the continuation
    diverges (the JAX package caught it on p3_gaussian)."""
    a = spec_ansatz(spec)
    with torch.no_grad():
        n = a.vgl(params, batch["x"], 1.0)
        batch = dict(batch)
        batch["base_val"] = batch["base_val"] + scale * n.value
        batch["base_grad"] = batch["base_grad"] + scale * n.grad
        batch["base_lap"] = batch["base_lap"] + scale * n.lap
        batch["base_bval"] = batch["base_bval"] + scale * a.value(params, batch["bx"], 1.0)
        if "base_val_reflect" in batch:
            batch["base_val_reflect"] = (batch["base_val_reflect"]
                                         + scale * a.value(params, batch["x_reflect"], 1.0))
    w_last, b_last = params[-1]
    w_new = 1e-3 * torch.randn(w_last.shape, generator=generator,
                               dtype=torch.float64)
    params = tuple(params[:-1]) + ((w_new.to(w_last), torch.zeros_like(b_last)),)
    return batch, params


def _eval_mu_x64(loss_fn, params, batch, gamma: float, scale: float) -> float:
    """μ (the loss aux) evaluated in float64 on the batch's device — the
    reporting twin of gauss_newton.lm_polish_x64."""
    from gpe_tpu_torch.train.gauss_newton import to_f64

    with torch.no_grad():
        _, aux = loss_fn(to_f64(params), to_f64(batch), float(gamma), float(scale))
    return float(aux["mu"])


def _numpy_params(params) -> tuple:
    return tuple((w.cpu().numpy(), b.cpu().numpy()) for w, b in params)


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
                 polish_x64_steps: int = 12,
                 verbose: bool = False, device=None) -> PLPINNResult:
    """Run the PL-PINN continuation sweep on `device` (None → the CUDA
    card). Seeds: the net of mode index mi starts from CPU generator seed
    `seed + 1000·mi`; the rebase after γ index gi draws from
    `(seed + 1000·mi)·1_000_003 + gi`.

    checkpoint_path: every completed (mode, γ) step is persisted
    (io.checkpoint.SweepCheckpointer, keys `{mode}:{γ!r}` and `state:{mode}`)
    and skipped on restart; the resumed ramp restores the params, the
    normalization constant, the scale and the folded base.
    polish_checkpoints: γ values at which to LM-polish a COPY of the current
    best params mid-ramp (the ramp continues unpolished) against the
    current, folded base; μ lands in polished[mode]["by_gamma"][γ].
    polish_x64=True appends a float64 LM endgame (`polish_x64_steps` steps,
    gauss_newton.lm_polish_x64) to each checkpoint polish and reports μ from
    a float64 evaluation, on `device` through the plain autograd path (the
    fused kernels are f32 only).

    mesh (a "data" mesh, parallel/mesh.py; its device replaces `device`) runs
    every fit with the collocation points sharded over its ranks, on the
    sharded plain loss (no fused gradient under a mesh, as in the JAX
    package); pretraining and the LM polishes run on the whole batch on
    every rank. Every rank returns the same result; only rank 0 writes the
    checkpoint and prints."""
    dev = resolve_device(device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    verbose = verbose and lead
    pin_full_f32()
    gs = [float(g) for g in gamma_values]
    gamma_values = sorted(gs, reverse=all(g <= 0 for g in gs) and any(g < 0 for g in gs))
    loss_fn = make_loss_fn(spec)
    fused_vag = None if mesh is not None else make_fused_value_and_grad(spec, device=dev)
    ckpt = None
    if checkpoint_path:
        from gpe_tpu_torch.io.checkpoint import SweepCheckpointer
        ckpt = SweepCheckpointer(checkpoint_path)
    polish_set = {float(g) for g in polish_checkpoints}

    params_by_mode, mu_table, training_history = {}, {}, {}
    constant_history, epochs_history, polished = {}, {}, {}
    seconds = {"pretrain": {}, "fit": {}, "lm": {}}
    for mi, mode in enumerate(modes):
        batch = make_batch(spec, mode, device=dev)
        mode_seed = seed + 1000 * mi
        params = mlp.init_mlp(spec.layers, "xavier_uniform",
                              generator=_generator(mode_seed), dtype=spec.dtype,
                              device=dev)
        resume_state = ckpt.get(f"state:{mode}") if ckpt else None
        done_gammas = set()
        t0 = time.perf_counter()
        if resume_state is not None:
            params = mlp.params_from_numpy(resume_state["params"], device=dev,
                                           dtype=spec.dtype)
            normal_const = float(resume_state["normal_const"])
            scale = float(resume_state["scale"])
            done_gammas = set(float(g) for g in resume_state["done_gammas"])
            if rebase and "base" in resume_state:
                for k, v in resume_state["base"].items():
                    batch[k] = torch.as_tensor(v, dtype=spec.dtype, device=dev)
            if verbose:
                print(f"mode {mode}: resumed past {len(done_gammas)} γ steps")
        elif spec.use_perturbation:
            target = base_triple(spec, mode, batch["x"]).value
            params, pre_mse = pretrain_to_base(params, batch["x"], target,
                                               spec.activation,
                                               epochs=pretrain_epochs, lr=1e-3)
            with torch.no_grad():
                normal_const = float(torch.max(
                    mlp.mlp_apply(params, batch["x"], spec.activation)))
            scale = perturb_const / normal_const
            seconds["pretrain"][mode] = time.perf_counter() - t0
            if verbose:
                print(f"mode {mode}: pretrain MSE {pre_mse:.3e} "
                      f"({pretrain_epochs} steps, {seconds['pretrain'][mode]:.2f} s)")
        else:
            normal_const = 1.0
            scale = 1.0
        constant_history[mode] = normal_const

        mus, by_gamma_params, by_gamma_hist, by_gamma_epochs = [], {}, {}, {}
        fit_s = seconds["fit"].setdefault(mode, {})
        optimizer = ramp_optimizer(lr, lr_mode)
        lm_ckpt = None
        for gi, gamma in enumerate(gamma_values):
            if ckpt is not None and gamma in done_gammas:
                saved = ckpt.get(f"{mode}:{gamma!r}")
                if saved is not None:
                    mus.append((gamma, float(saved["mu"])))
                    if keep_params:
                        by_gamma_params[gamma] = saved["params"]
                    by_gamma_hist[gamma] = {"loss": saved["loss_history"],
                                            "mu": saved["mu_history"]}
                    by_gamma_epochs[gamma] = int(saved["epochs_run"])
                    continue
            t0 = time.perf_counter()
            res = fit(loss_fn, optimizer, params, batch, gamma, scale,
                      epochs=epochs, tol=tol, patience=patience,
                      check_every=check_every, value_and_grad_fn=fused_vag,
                      mesh=mesh)
            fit_s[gamma] = time.perf_counter() - t0
            params = res.params
            mus.append((gamma, res.mu_best))
            if keep_params:
                by_gamma_params[gamma] = _numpy_params(res.params)
            by_gamma_hist[gamma] = {"loss": res.loss_history, "mu": res.mu_history}
            by_gamma_epochs[gamma] = res.epochs_run
            if verbose:
                print(f"mode {mode} γ={gamma:g}: μ={res.mu:.6f} "
                      f"loss={res.best_loss:.3e} epochs={res.epochs_run} "
                      f"({fit_s[gamma]:.2f} s, "
                      f"{1e3 * fit_s[gamma] / max(res.epochs_run, 1):.3f} ms/step)")
            if gamma in polish_set:
                # mid-ramp LM polish on a COPY of the best params against the
                # CURRENT batch (with rebase=True the folded base the fit
                # trained against); the ramp continues unpolished
                from gpe_tpu_torch.train.gauss_newton import (lm_polish_x64,
                                                              make_gpe_residual_fn,
                                                              make_lm_solver)
                if lm_ckpt is None:
                    lm_ckpt = make_lm_solver(make_gpe_residual_fn(spec), params,
                                             steps=lm_steps, cg_iters=lm_cg_iters)
                res_lm = lm_ckpt(params, batch, gamma, scale)
                if polish_x64:
                    res_lm = lm_polish_x64(make_gpe_residual_fn(spec), res_lm.params,
                                           batch, gamma, scale,
                                           steps=polish_x64_steps,
                                           cg_iters=lm_cg_iters)
                    mu_ck = _eval_mu_x64(loss_fn, res_lm.params, batch, gamma, scale)
                else:
                    with torch.no_grad():
                        mu_ck = float(loss_fn(res_lm.params, batch, gamma, scale)[1]["mu"])
                polished.setdefault(mode, {}).setdefault("by_gamma", {})[gamma] = mu_ck
                if verbose:
                    print(f"mode {mode} γ={gamma:g}: checkpoint LM μ={mu_ck:.7f}")
            if rebase:
                batch, params = _rebase(spec, batch, params, scale,
                                        _generator(mode_seed * 1_000_003 + gi))
            if ckpt is not None and lead:
                done_gammas.add(gamma)
                ckpt.put(f"{mode}:{gamma!r}", {
                    "mu": res.mu_best, "params": res.params,
                    "loss_history": res.loss_history,
                    "mu_history": res.mu_history,
                    "epochs_run": res.epochs_run})
                state = {"params": params, "normal_const": normal_const,
                         "scale": scale, "done_gammas": sorted(done_gammas)}
                if rebase:
                    state["base"] = {k: batch[k] for k in
                                     ("base_val", "base_grad", "base_lap",
                                      "base_bval") if k in batch}
                ckpt.put(f"state:{mode}", state)

        params_by_mode[mode] = by_gamma_params
        mu_table[mode] = mus
        training_history[mode] = by_gamma_hist
        epochs_history[mode] = by_gamma_epochs

        if lm_polish and mus:
            from gpe_tpu_torch.train.gauss_newton import (make_gpe_residual_fn,
                                                          make_lm_solver)
            t0 = time.perf_counter()
            lm = make_lm_solver(make_gpe_residual_fn(spec), params,
                                steps=lm_steps, cg_iters=lm_cg_iters)
            g_last = mus[-1][0]
            res_lm = lm(params, batch, g_last, scale)
            with torch.no_grad():
                _, aux_lm = loss_fn(res_lm.params, batch, g_last, scale)
            entry = polished.setdefault(mode, {})
            entry.update({"gamma": g_last, "mu": float(aux_lm["mu"]),
                          "steps": lm_steps})
            seconds["lm"][mode] = time.perf_counter() - t0
            if keep_params:
                entry["params"] = _numpy_params(res_lm.params)
                entry["scale"] = float(scale)
                if "base_val" in batch:
                    entry["base_val"] = batch["base_val"].cpu().numpy()
            if verbose:
                print(f"mode {mode} γ={g_last:g}: LM-polished μ={entry['mu']:.7f} "
                      f"({lm_steps} steps, {seconds['lm'][mode]:.2f} s)")

    return PLPINNResult(params_by_mode, mu_table, training_history,
                        constant_history, epochs_history, polished, seconds)
