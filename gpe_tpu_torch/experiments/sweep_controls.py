"""The controls behind chip_smoke.py phase 7a's bounds, on the β sweep of
`vary_beta_gravity_well` (4,000 points, [1,64,64,64,1], β 1…100, the
runner's `beta_sweep` arguments at SWEEP_EPOCHS steps a rung), on the card:

    python -m gpe_tpu_torch.experiments.sweep_controls

prints one JSON line a row:

- "sweep": the sweep on each route (`sweep`), its μ table and each μ's
  relative gap to the card's autograd route. Routes that differ from it
  in f32 rounding alone: "relaxed" (the default relaxed K2 step) and
  "relaxed_again" (the same, run again), "exact" (the two-kernel K2
  step), "autograd_reordered" and "relaxed_reordered" (the collocation
  points in another order), "autograd_cpu" (autograd on the host's CPU).
  Routes with a fault planted in the relaxed K2 step (FAULTS): "stale"
  and "no_bias_grad".
- "steps": `route_steps` from the relaxed route's params: ROUTES_STEPS
  steps of every rung by the exact, the relaxed and the faulty K2 steps,
  each against autograd from the same params.

The module's functions also serve phase 7a and run on the CPU too (the
kernels' plain versions).
"""
from __future__ import annotations

import contextlib
import json

import numpy as np

CONFIG = "vary_beta_gravity_well"
SWEEP_EPOCHS, ROUTES_STEPS = 300, 10


def stale_cotangents(vag):
    """The relaxed step with a fault: its state's cotangent sums are never
    advanced, so every step builds its cotangents from the sums of the
    fit's first params (the values stay fresh)."""
    def stale(params, batch, gamma, scale, state, group=None):
        value, grads, new = vag(params, batch, gamma, scale, state, group=group)
        return value, grads, (state[0], state[1], new[2])
    stale.stateful, stale.init_state = True, vag.init_state
    return stale


def no_bias_grad(vag):
    """The relaxed step with a fault: the output layer's bias gradient is
    dropped (zero)."""
    import torch

    def dropped(params, batch, gamma, scale, state, group=None):
        value, grads, new = vag(params, batch, gamma, scale, state, group=group)
        *rest, (w, b) = grads
        return value, (*rest, (w, torch.zeros_like(b))), new
    dropped.stateful, dropped.init_state = True, vag.init_state
    return dropped


FAULTS = {"stale": stale_cotangents, "no_bias_grad": no_bias_grad}


def make_vag(spec, route: str):
    """The value-and-grad of a route: None (autograd), "exact", "relaxed"
    (the default: fresh values, extrapolated cotangents) or a FAULTS name
    (the relaxed step with that fault); the kernels on the card, their
    plain versions on the CPU."""
    from gpe_tpu_torch.kernels import fused_grad

    if route == "autograd":
        return None
    phys = (spec.layers, spec.activation, spec.p, spec.kinetic, spec.nonlinearity)
    weights = dict(bc_weight=spec.bc_weight, norm_weight=spec.norm_weight)
    if route == "exact":
        return fused_grad.make_value_and_grad(*phys, **weights, delayed=False)
    vag = fused_grad.make_value_and_grad(*phys, **weights, delayed=True,
                                         fresh_values=True, extrapolate=True)
    return vag if route == "relaxed" else FAULTS[route](vag)


def reordered(batch: dict, seed: int = 1) -> dict:
    """The batch with its collocation points in a permuted order (the
    boundary points as they are)."""
    import torch

    n = batch["x"].shape[0]
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(n),
                           device=batch["x"].device)
    return {k: (v[perm] if k in ("x", "w", "V", "base_val", "base_grad", "base_lap")
                else v) for k, v in batch.items()}


@contextlib.contextmanager
def _route(route: str, reorder: bool):
    from gpe_tpu_torch.train import beta_sweep

    saved = beta_sweep.make_fused_value_and_grad, beta_sweep.make_batch
    beta_sweep.make_fused_value_and_grad = lambda spec, device=None: make_vag(spec, route)
    if reorder:
        beta_sweep.make_batch = lambda *a, **kw: reordered(saved[1](*a, **kw))
    try:
        yield
    finally:
        beta_sweep.make_fused_value_and_grad, beta_sweep.make_batch = saved


def sweep(route: str, device, reorder: bool = False):
    """The runner's β sweep (`train_beta_sweep` with the config's
    arguments) on `route` (`make_vag`), its points reordered or not."""
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.train.beta_sweep import train_beta_sweep

    cfg = EXPERIMENTS[CONFIG]
    with _route(route, reorder):
        return train_beta_sweep(cfg.spec, cfg.beta_values, gamma=cfg.gamma_values[0],
                                modes=cfg.modes, epochs=SWEEP_EPOCHS, tol=cfg.tol,
                                patience=cfg.patience, perturb_const=cfg.perturb_const,
                                lr=cfg.lr, seed=cfg.seed,
                                pretrain_epochs=cfg.pretrain_epochs, device=device)


def route_steps(params_by_beta: dict, normal_const: float, device,
                routes=("exact", "relaxed")):
    """For each β past the first, ROUTES_STEPS fit steps at that β (the
    runner's ramp optimizer, the sweep's scale) from the params of the
    rung before, on each route and on autograd: {β: {route: the worst
    relative gap of its loss and μ histories to autograd's}}."""
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.models.mlp import params_from_numpy
    from gpe_tpu_torch.train.beta_sweep import beta_scaled
    from gpe_tpu_torch.train.loop import fit
    from gpe_tpu_torch.train.plpinn import ramp_optimizer
    from gpe_tpu_torch.train.problem import make_batch, make_loss_fn

    cfg = EXPERIMENTS[CONFIG]
    spec = cfg.spec
    betas = sorted(params_by_beta)
    unit = make_batch(spec, 0, device=device)
    scale = cfg.perturb_const / normal_const
    loss_fn = make_loss_fn(spec)
    gaps = {}
    for prev, b in zip(betas[:-1], betas[1:]):
        params = params_from_numpy(params_by_beta[prev], device=device)
        batch = beta_scaled(unit, b)
        hist = {}
        for route in ("autograd", *routes):
            r = fit(loss_fn, ramp_optimizer(cfg.lr), params, batch, cfg.gamma_values[0],
                    scale, epochs=ROUTES_STEPS, tol=-1.0, patience=10**9,
                    check_every=ROUTES_STEPS, value_and_grad_fn=make_vag(spec, route))
            hist[route] = (r.loss_history, r.mu_history)
        gaps[b] = {route: max(float(np.max(np.abs(hist[route][i] / hist["autograd"][i]
                                                  - 1.0))) for i in (0, 1))
                   for route in routes}
    return gaps


def mu_gaps(table: dict, ref: dict) -> dict:
    """{β: |μ/μ_ref − 1|} of two μ tables."""
    return {b: abs(table[b] / ref[b] - 1.0) for b in ref}


def main() -> int:
    import torch

    from gpe_tpu_torch.device import pin_full_f32, resolve_device
    from gpe_tpu_torch.kernels import _build

    resolve_device()                # raises when there is no card
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pin_full_f32()
    _build.build_all()
    runs = {"autograd": ("autograd", dev, False), "relaxed": ("relaxed", dev, False),
            "relaxed_again": ("relaxed", dev, False), "exact": ("exact", dev, False),
            "autograd_reordered": ("autograd", dev, True),
            "relaxed_reordered": ("relaxed", dev, True),
            "autograd_cpu": ("autograd", "cpu", False),
            **{f: (f, dev, False) for f in FAULTS}}
    tables, res = {}, {}
    for label, (route, device, reorder) in runs.items():
        res[label] = sweep(route, device, reorder)
        tables[label] = dict(res[label].mu_table[0])
        print(json.dumps({"row": "sweep", "route": label, "mu": tables[label],
                          "gap_to_autograd": mu_gaps(tables[label], tables["autograd"])}),
              flush=True)
    ref = res["relaxed"]
    steps = route_steps(ref.params_by_mode[0], ref.constant_history[0], dev,
                        routes=("exact", "relaxed", *FAULTS))
    print(json.dumps({"row": "steps", "gaps": steps}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
