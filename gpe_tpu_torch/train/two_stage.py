"""Two-stage β→γ continuation, port of `gpe_tpu/train/two_stage.py`
(`TwoStageResult`, `_beta_scaled_loss`, `train_two_stage`).

Stage 1 ramps the potential scale β at γ = 0, warm-starting each rung;
stage 2 holds β at the last β and ramps the interaction strength γ. Both
stages share one loss, whose γ argument is the f32 pair (β, γ): β scales
the potential inside the loss. `fit` passes that pair through untouched
(no fused gradient is given; its kernels take a scalar γ), so both stages
train by autograd, as in the JAX package.
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple

import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.train.loop import fit
from gpe_tpu_torch.train.optimizers import make_optimizer
from gpe_tpu_torch.train.plpinn import _generator, _numpy_params
from gpe_tpu_torch.train.pretrain import pretrain_to_base
from gpe_tpu_torch.train.problem import GPESpec, base_triple, make_batch, make_loss_fn
from gpe_tpu_torch.train.schedules import cosine_warm_restarts


class TwoStageResult(NamedTuple):
    mu_beta: list            # stage 1: [(beta, mu)]
    mu_gamma: list           # stage 2: [(gamma, mu)]
    params: Any              # final best params (numpy)
    history: dict            # {("beta", b) | ("gamma", g): {"loss", "mu"}}
    epochs: dict
    seconds: dict = None     # {"pretrain": s, "fit": {"beta=<b>" | "gamma=<g>": s}}


def _beta_scaled_loss(spec: GPESpec):
    """The spec's loss with γ given as the pair (β, γ): V_eff = β·V."""
    inner = make_loss_fn(spec)

    def loss_fn(params, batch, beta_gamma, scale):
        beta, gamma = beta_gamma
        b = dict(batch)
        b["V"] = beta * batch["V"]
        return inner(params, b, gamma, scale)

    return loss_fn


def train_two_stage(spec: GPESpec, beta_values, gamma_values, mode: int = 0,
                    epochs: int = 5001, tol: float = 1e-5, patience: int = 2000,
                    perturb_const: float = 0.01, lr: float = 1e-3, seed: int = 0,
                    pretrain_epochs: int = 2000, check_every: int = 512,
                    verbose: bool = False, device=None) -> TwoStageResult:
    """Stage 1 over the sorted β (γ = 0), stage 2 over the sorted γ at the
    last β, on `device` (None → the CUDA card); the net starts from CPU
    generator seed `seed`."""
    dev = resolve_device(device)
    pin_full_f32()
    beta_values = sorted(float(b) for b in beta_values)
    gamma_values = sorted(float(g) for g in gamma_values)
    loss_fn = _beta_scaled_loss(spec)
    batch = make_batch(spec, mode, device=dev)

    t0 = time.perf_counter()
    params = mlp.init_mlp(spec.layers, "xavier_uniform", generator=_generator(seed),
                          dtype=spec.dtype, device=dev)
    target = base_triple(spec, mode, batch["x"]).value
    params, _ = pretrain_to_base(params, batch["x"], target, spec.activation,
                                 epochs=pretrain_epochs)
    with torch.no_grad():
        normal_const = float(torch.max(mlp.mlp_apply(params, batch["x"],
                                                     spec.activation)))
    scale = perturb_const / normal_const
    seconds = {"pretrain": time.perf_counter() - t0, "fit": {}}

    history, eps = {}, {}
    opt = make_optimizer("adam", cosine_warm_restarts(lr, 200, 2, 1e-6), clip_norm=1.0)

    def run_step(beta, gamma, key):
        nonlocal params
        t0 = time.perf_counter()
        res = fit(loss_fn, opt, params, batch,
                  torch.tensor([beta, gamma], dtype=torch.float32), scale,
                  epochs=epochs, tol=tol, patience=patience, check_every=check_every)
        seconds["fit"][f"{key[0]}={key[1]:g}"] = time.perf_counter() - t0
        params = res.params
        history[key] = {"loss": res.loss_history, "mu": res.mu_history}
        eps[key] = res.epochs_run
        if verbose:
            print(f"{key}: μ={res.mu:.6f} loss={res.best_loss:.3e} ep={res.epochs_run}")
        return res.mu_best

    mu_beta = [(b, run_step(b, 0.0, ("beta", b))) for b in beta_values]
    beta_max = beta_values[-1] if beta_values else 1.0
    mu_gamma = [(g, run_step(beta_max, g, ("gamma", g))) for g in gamma_values]

    return TwoStageResult(mu_beta, mu_gamma, _numpy_params(params), history, eps,
                          seconds)
