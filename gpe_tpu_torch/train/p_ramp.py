"""Nonlinearity-power (p) continuation, port of `gpe_tpu/train/p_ramp.py`
(`PRampResult`, `train_p_ramp`): γ fixed, the power p ramped over the
sorted values, each p warm-started from the previous p's restored best
state. p is a field of the spec, so each p has its own loss
(`dataclasses.replace(spec, p=p)`); no fused gradient is passed, as in
the JAX package, so every step is autograd of that loss.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import NamedTuple

import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.train.loop import fit
from gpe_tpu_torch.train.optimizers import make_optimizer
from gpe_tpu_torch.train.plpinn import _generator, _numpy_params
from gpe_tpu_torch.train.pretrain import pretrain_to_base
from gpe_tpu_torch.train.problem import GPESpec, base_triple, make_batch, make_loss_fn
from gpe_tpu_torch.train.schedules import cosine_warm_restarts


class PRampResult(NamedTuple):
    params_by_p: dict           # p -> best params (numpy)
    mu_table: list              # [(p, mu)]
    training_history: dict      # p -> {"loss", "mu"}
    epochs_history: dict        # p -> epochs_run
    seconds: dict = None        # {"pretrain": s, "fit": {p: s}}


def train_p_ramp(spec: GPESpec, p_values, gamma: float, mode: int = 0,
                 epochs: int = 3001, tol: float = 1e-5, patience: int = 2000,
                 perturb_const: float = 0.01, lr: float = 1e-3, seed: int = 0,
                 pretrain_epochs: int = 2000, check_every: int = 512,
                 verbose: bool = False, device=None) -> PRampResult:
    """Ramp the nonlinearity power p at fixed γ on `device` (None → the
    CUDA card), warm-starting across p; the net starts from CPU generator
    seed `seed`."""
    dev = resolve_device(device)
    pin_full_f32()
    p_values = sorted(float(p) for p in p_values)
    batch = make_batch(spec, mode, device=dev)
    params = mlp.init_mlp(spec.layers, "xavier_uniform", generator=_generator(seed),
                          dtype=spec.dtype, device=dev)

    seconds = {"fit": {}}
    if spec.use_perturbation:
        t0 = time.perf_counter()
        target = base_triple(spec, mode, batch["x"]).value
        params, _ = pretrain_to_base(params, batch["x"], target, spec.activation,
                                     epochs=pretrain_epochs)
        with torch.no_grad():
            normal_const = float(torch.max(
                mlp.mlp_apply(params, batch["x"], spec.activation)))
        scale = perturb_const / normal_const
        seconds["pretrain"] = time.perf_counter() - t0
    else:
        scale = 1.0

    optimizer = make_optimizer(
        "adam", cosine_warm_restarts(lr, T_0=200, T_mult=2, eta_min=1e-6),
        clip_norm=1.0)
    params_by_p, mus, hist, eps = {}, [], {}, {}
    for p in p_values:
        t0 = time.perf_counter()
        res = fit(make_loss_fn(replace(spec, p=p)), optimizer, params, batch, gamma,
                  scale, epochs=epochs, tol=tol, patience=patience,
                  check_every=check_every)
        seconds["fit"][p] = time.perf_counter() - t0
        params = res.params              # warm start the next p
        params_by_p[p] = _numpy_params(res.params)
        mus.append((p, res.mu_best))
        hist[p] = {"loss": res.loss_history, "mu": res.mu_history}
        eps[p] = res.epochs_run
        if verbose:
            print(f"p={p:g}: μ={res.mu:.6f} loss={res.best_loss:.3e} "
                  f"epochs={res.epochs_run} ({seconds['fit'][p]:.2f} s)")

    return PRampResult(params_by_p, mus, hist, eps, seconds)
