"""Excited states by deflation, port of `gpe_tpu/train/deflation.py`
(`DeflationResult`, `make_deflated_loss_fn`, `_make_polish`,
`_normalized_mu`, `train_deflation`).

Modes train SEQUENTIALLY from random inits, with no analytic base: mode n
minimises the GPE loss plus an orthogonality penalty against every
converged lower state,

    L_orth = Σ_{k<n} ⟨ψ̂, ψ_k⟩²,   ψ̂ = ψ / ‖ψ‖,

where the lower states are frozen value arrays on the collocation grid
(`batch["orth_states"]`, (K, N)). Each state may then be sharpened by a
Levenberg–Marquardt polish of the scale-invariant GPE residual
(`gauss_newton.make_lm_solver`, its CG matvec a CUDA graph on the card).
No fused gradient is passed, as in the JAX package: the penalty is not a
term the kernels model.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.losses.balancing import fixed_weights_total
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.ops.rayleigh import hamiltonian_apply
from gpe_tpu_torch.train.loop import fit
from gpe_tpu_torch.train.optimizers import make_optimizer
from gpe_tpu_torch.train.problem import GPESpec, make_batch, make_terms_fn
from gpe_tpu_torch.train.schedules import cosine_warm_restarts


class DeflationResult(NamedTuple):
    params_by_mode: dict       # mode index -> best (polished) params
    mu_table: list             # [(mode, mu)] ascending
    states: np.ndarray         # (n_modes, N) converged normalised states
    history_by_mode: dict      # mode -> {"loss", "mu"}
    seconds: dict = None       # {"fit": {mode: s}, "lm": {mode: s}}


def make_deflated_loss_fn(spec: GPESpec, orth_weight: float = 100.0):
    """loss_fn(params, batch, gamma, scale) with an orthogonality penalty
    against batch["orth_states"] ((K, N) frozen lower states; K may be 0,
    and the key may be absent)."""
    terms_fn = make_terms_fn(spec)
    weights = spec.loss_weights()

    def loss_fn(params, batch, gamma, scale):
        out = terms_fn(params, batch, gamma, scale)
        total = fixed_weights_total(out.losses, weights)
        aux = dict(out.losses)
        states = batch.get("orth_states")
        if states is not None and states.shape[0] > 0:
            # normalised overlaps ⟨ψ̂, ψ_k⟩ — scale-invariant, so shrinking
            # ‖ψ‖ cannot cheat the penalty before the norm constraint bites
            nrm2 = torch.sum(out.u * out.u * batch["w"])
            overlaps = states @ (out.u * batch["w"])
            overlaps = overlaps / torch.sqrt(nrm2 + 1e-30)
            orth = torch.sum(overlaps * overlaps)
            total = total + orth_weight * orth
            aux["orth"] = orth
        aux["mu"] = out.mu
        aux["total"] = total
        return total, aux

    return loss_fn


def _normalized_parts(spec, params, batch, gamma):
    """(u, H u) of the net's output normalised to ∫u²·w = 1."""
    n = mlp.mlp_vgl(params, batch["x"], spec.activation)
    norm = torch.sqrt(torch.sum(n.value ** 2 * batch["w"]) + 1e-30)
    u = n.value / norm
    lap = n.lap / norm
    return u, hamiltonian_apply(u, lap, batch["V"], gamma, spec.p, spec.kinetic,
                                spec.nonlinearity)


def _make_polish(spec: GPESpec, params_template, steps: int, cg_iters: int):
    """LM solver on the NORMALISED mesh-free GPE residual (scale-invariant):
    it sharpens each deflated state to the nearby exact eigenpair."""
    from gpe_tpu_torch.train.gauss_newton import make_lm_solver

    def residuals(p, b, g, s):
        u, hu = _normalized_parts(spec, p, b, g)
        mu = torch.sum(u * hu) / (torch.sum(u * u) + 1e-12)
        return (hu - mu * u) / math.sqrt(float(u.shape[0]))

    return make_lm_solver(residuals, params_template, steps=steps, cg_iters=cg_iters)


def _normalized_mu(spec, params, batch, gamma):
    """The Rayleigh quotient of the net's output normalised to ∫u²·w = 1:
    the nonlinear term's strength depends on that normalisation, so the raw
    quotient drifts with the residual normalisation error."""
    with torch.no_grad():
        u, hu = _normalized_parts(spec, params, batch, gamma)
        return torch.sum(u * hu) / (torch.sum(u * u) + 1e-12)


def train_deflation(spec: GPESpec, gamma: float, n_modes: int = 3,
                    epochs: int = 4000, tol: float = 1e-7,
                    patience: int = 10**9, lr: float = 2e-3, seed: int = 0,
                    orth_weight: float = 100.0, check_every: int = 512,
                    polish_steps: int = 0, polish_cg_iters: int = 60,
                    verbose: bool = False, device=None) -> DeflationResult:
    """Sequentially train the lowest n_modes eigenstates of the GPE at fixed
    γ with deflation, on `device` (None → the CUDA card), with the vanilla
    ansatz (no analytic base). Mode n starts from a "mode_scaled" init of
    CPU generator seed `seed + 7·n`; its normalised state joins the frozen
    orthogonality set for the next mode. With polish_steps > 0 each state
    is LM-polished and its μ read from the normalised polished state."""
    dev = resolve_device(device)
    pin_full_f32()
    spec = dataclasses.replace(spec, use_perturbation=False)
    batch = dict(make_batch(spec, 0, device=dev))
    loss_fn = make_deflated_loss_fn(spec, orth_weight)
    w = batch["w"]

    states = torch.zeros((0, batch["x"].shape[0]), dtype=spec.dtype, device=dev)
    params_by_mode, mus, hist = {}, [], {}
    seconds = {"fit": {}, "lm": {}}
    polish = None
    for n in range(n_modes):
        batch["orth_states"] = states
        params = mlp.init_mlp(spec.layers, "mode_scaled", mode=n,
                              generator=torch.Generator().manual_seed(seed + 7 * n),
                              dtype=spec.dtype, device=dev)
        opt = make_optimizer(
            "adam", cosine_warm_restarts(lr, T_0=200, T_mult=2, eta_min=1e-6),
            clip_norm=1.0)
        t0 = time.perf_counter()
        res = fit(loss_fn, opt, params, batch, gamma, 1.0, epochs=epochs,
                  tol=tol, patience=patience, check_every=check_every)
        seconds["fit"][n] = time.perf_counter() - t0
        best = res.params
        mu_n = res.mu_best
        if polish_steps > 0:
            t0 = time.perf_counter()
            if polish is None:
                polish = _make_polish(spec, best, polish_steps, polish_cg_iters)
            best = polish(best, batch, gamma, 1.0).params
            # the polish residual is scale-invariant, so the raw net norm is
            # arbitrary afterwards: μ must be read from the NORMALISED state
            # (the nonlinear term's strength depends on ∫u² = 1)
            mu_n = float(_normalized_mu(spec, best, batch, gamma))
            seconds["lm"][n] = time.perf_counter() - t0
        with torch.no_grad():
            u = mlp.mlp_apply(best, batch["x"], spec.activation)
            u = u / torch.sqrt(torch.sum(u * u * w) + 1e-30)
        states = torch.cat([states, u[None, :]], dim=0)
        params_by_mode[n] = best
        mus.append((n, mu_n))
        hist[n] = {"loss": res.loss_history, "mu": res.mu_history}
        if verbose:
            print(f"deflation mode {n}: μ={mu_n:.6f} (fit μ={res.mu_best:.6f}, "
                  f"loss={res.best_loss:.3e}, {seconds['fit'][n]:.2f} s)")

    return DeflationResult(params_by_mode, mus, states.cpu().numpy(), hist, seconds)
