"""The controls behind chip_smoke.py phase 11a's bound on the bf16 fits:
STEPS steps of `fit(value_and_grad_fn=)` at `gpe2d_ground_state`'s shape
(50,176 points, [2,128,128,128,1], γ 5, scale 0.05) and of `fit_ensemble`
at `harmonic_paper`'s six runs (per-run γ and scale), each with K2's bf16
vag, on the card:

    python -m gpe_tpu_torch.experiments.bf16_fit_controls

prints one JSON line a route: the worst relative gap of its two loss
histories (`hist_rel`) to those of the card's relaxed bf16 route. Routes
that differ from it in f32 rounding alone: "relaxed_again" (the same, run
again), "relaxed_reordered" (the collocation points in another order,
`sweep_controls.reordered`), "relaxed_cpu" (the bf16 plain versions on the
host's CPU). "exact": the two-kernel bf16 step, whose cotangents come from
K1-bf16's sums (weights rounded too), a different rounding of the same
loss. Routes with a fault planted in the relaxed step
(`sweep_controls.FAULTS`, applied to the vag and its run-mode twin):
"stale" and "no_bias_grad".

The module's functions also serve phase 11a and run on the CPU too (the
kernels' plain versions).
"""
from __future__ import annotations

import json

import numpy as np

STEPS = 10
SINGLE, ENSEMBLE = "gpe2d_ground_state", "harmonic_paper"


def make_vag(spec, route: str = "relaxed", dtype=None):
    """K2's vag of a route in `dtype` (bf16 by default): "exact",
    "relaxed" (fresh values, extrapolated cotangents) or a FAULTS name (the
    relaxed step with that fault, its `.run_axis` twin too)."""
    import torch

    from gpe_tpu_torch.experiments.sweep_controls import FAULTS
    from gpe_tpu_torch.kernels.fused_grad import make_value_and_grad

    phys = (spec.layers, spec.activation, spec.p, spec.kinetic, spec.nonlinearity)
    kw = dict(bc_weight=spec.bc_weight, norm_weight=spec.norm_weight,
              compute_dtype=dtype or torch.bfloat16)
    if route == "exact":
        return make_value_and_grad(*phys, **kw, delayed=False)
    vag = make_value_and_grad(*phys, **kw, delayed=True, fresh_values=True,
                              extrapolate=True)
    if route == "relaxed":
        return vag
    faulty = FAULTS[route](vag)
    faulty.run_axis = FAULTS[route](vag.run_axis)
    return faulty


def problems(device) -> dict:
    """The two fits' problems on `device`: {"single": (spec, batch, params),
    "ensemble": (spec, batch, run-stacked params, γs, scales, lr)}."""
    import torch

    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.models.mlp import init_mlp, stack_runs
    from gpe_tpu_torch.train.problem import make_batch

    mspec = EXPERIMENTS[SINGLE].spec
    mparams = init_mlp(mspec.layers, "xavier_uniform",
                       generator=torch.Generator().manual_seed(0), device=device)
    ecfg = EXPERIMENTS[ENSEMBLE]
    eparams = stack_runs([init_mlp(ecfg.spec.layers, "xavier_uniform",
                                   generator=torch.Generator().manual_seed(42 + r),
                                   device=device) for r in range(6)])
    return {"single": (mspec, make_batch(mspec, 0, device=device), mparams),
            "ensemble": (ecfg.spec, make_batch(ecfg.spec, 0, device=device), eparams,
                         [20.0 * r for r in range(6)], [0.01 * (1 + r) for r in range(6)],
                         ecfg.lr)}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: v.to(device) for k, v in tree.items()}
    return tuple(tuple(t.to(device) for t in p) for p in tree)


def fits(probs: dict, device, route: str = "relaxed", dtype=None,
         reorder: bool = False):
    """(fit's result, fit_ensemble's result) of STEPS steps on `route`
    (`make_vag`) from `probs`' params, moved to `device`, the points
    reordered or not."""
    from gpe_tpu_torch.experiments.sweep_controls import reordered
    from gpe_tpu_torch.train.loop import fit, fit_ensemble
    from gpe_tpu_torch.train.plpinn import ramp_optimizer
    from gpe_tpu_torch.train.problem import make_loss_fn

    kw = dict(epochs=STEPS, tol=-1.0, patience=10 ** 9, check_every=STEPS)
    mspec, mbatch, mparams = probs["single"]
    espec, ebatch, eparams, gammas, scales, lr = probs["ensemble"]
    mbatch, ebatch = _to(mbatch, device), _to(ebatch, device)
    if reorder:
        mbatch, ebatch = reordered(mbatch), reordered(ebatch)
    single = fit(make_loss_fn(mspec), ramp_optimizer(1e-3), _to(mparams, device), mbatch,
                 5.0, 0.05, value_and_grad_fn=make_vag(mspec, route, dtype), **kw)
    ens = fit_ensemble(make_loss_fn(espec), ramp_optimizer(lr), _to(eparams, device),
                       ebatch, gammas, scales,
                       value_and_grad_fn=make_vag(espec, route, dtype), **kw)
    return single, ens


def hist_rel(got, want) -> float:
    """The worst |got/want − 1| over two loss histories."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def gaps(got, want) -> dict:
    """{"fit": …, "fit_ensemble": …}: `hist_rel` of two `fits` results."""
    return {what: hist_rel(g.loss_history, w.loss_history)
            for what, g, w in zip(("fit", "fit_ensemble"), got, want)}


def main() -> int:
    import torch

    from gpe_tpu_torch.device import pin_full_f32, resolve_device
    from gpe_tpu_torch.experiments.sweep_controls import FAULTS
    from gpe_tpu_torch.kernels import _build

    resolve_device()                # raises when there is no card
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pin_full_f32()
    _build.build_all()
    probs = problems(dev)
    ref = fits(probs, dev)
    runs = {"relaxed_again": ("relaxed", dev, False),
            "relaxed_reordered": ("relaxed", dev, True),
            "relaxed_cpu": ("relaxed", torch.device("cpu"), False),
            "exact": ("exact", dev, False),
            **{f: (f, dev, False) for f in FAULTS}}
    for label, (route, device, reorder) in runs.items():
        print(json.dumps({"route": label,
                          "gap_to_relaxed": gaps(fits(probs, device, route,
                                                      reorder=reorder), ref)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
