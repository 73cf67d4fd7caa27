"""The controls behind chip_smoke.py phase 8's bounds, on the card at the
main shape (`gpe2d_ground_state`: 50,176 points, [2,128,128,128,1]) over
two gloo ranks on one card:

    python -m gpe_tpu_torch.experiments.mesh_controls

prints one JSON line a row:

- "reordered": STEPS Adam steps (the config's lr, clip 1.0) of the fused
  fit from three starts (random params at γ 5, s 0.05; the net pretrained
  PRETRAIN steps to the base at γ 0 and at γ 5), with the default relaxed
  step and with the exact one: the sharded fit (`fit(mesh=)`) and the
  unsharded fit on its points reordered, each against the unsharded fit —
  best loss and μ_best relative, and the first step at which the loss
  history leaves the unsharded one by 1e-4.
- "conditioning": four-step walks of the fused vag (`mesh_check.walk`)
  from the pretrained net at γ 5 (step 1e-3) and from random params (step
  1e-6), default relaxed with and without the K1 correctors (CORRECTORS)
  and exact: the sharded vag and the unsharded one on reordered points,
  each against the unsharded vag, per step — total relative, gradients
  normalised per leaf, the relaxed state relative.
- "fault": the sharded relaxed fit from the pretrained net at γ 5 with the
  cotangents built from the local point count where the global one belongs
  (`case_fit_local_count`, injected in the ranks), against the unsharded
  fit: the first 10 steps' loss and μ, best loss and μ_best.
"""
from __future__ import annotations

import json
import sys

import numpy as np

STEPS, PRETRAIN, GAMMA, SCALE = 200, 300, 5.0, 0.05
CORRECTORS = dict(refresh_every=2, exact_until=2)


def case_fit_local_count(mesh, **kw):
    """`mesh_check.case_fit` on a rank whose fused step builds its
    cotangents from this rank's point count: the fault of a psum-aware vag
    that forgets the global count. The rank keeps the fault, so run it as
    its last case."""
    from gpe_tpu_torch.experiments.mesh_check import case_fit
    from gpe_tpu_torch.kernels import fused_grad, fused_residual

    def local_count(sums, n, norm_weight):
        mu, pde, norm, _ = fused_residual.sums_to_loss(sums, n, norm_weight)
        cots = fused_residual.sums_to_loss(sums, n // mesh.size, norm_weight)[3]
        return mu, pde, norm, cots

    fused_grad.sums_to_loss = local_count
    return case_fit(mesh, **kw)


def _rel(got, want) -> list:
    """|got / want − 1|, elementwise, as a list (a float for scalars)."""
    r = np.abs(np.asarray(got, np.float64) / np.asarray(want, np.float64) - 1)
    return r.tolist()


def _first_off(hist, ref, tol: float = 1e-4):
    d = np.abs(np.asarray(hist, np.float64) / np.asarray(ref, np.float64) - 1)
    return int(np.argmax(d > tol)) if (d > tol).any() else None


def _grad_err(got, want, layers) -> float:
    """max over the leaves of max|Δ| / max|want| of two flat gradients."""
    sizes = [n for k, m in zip(layers[:-1], layers[1:]) for n in (k * m, m)]
    cuts = np.cumsum(sizes)[:-1]
    return max(float(np.abs(g - w).max() / (np.abs(w).max() + 1e-30))
               for g, w in zip(np.split(got, cuts), np.split(want, cuts)))


def main() -> int:
    import torch

    from gpe_tpu_torch.device import pin_full_f32, resolve_device
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.experiments.mesh_check import run_cases, walk
    from gpe_tpu_torch.kernels import _build
    from gpe_tpu_torch.models.mlp import init_mlp, mlp_apply
    from gpe_tpu_torch.train.loop import fit
    from gpe_tpu_torch.train.optimizers import make_optimizer
    from gpe_tpu_torch.train.pretrain import pretrain_to_base
    from gpe_tpu_torch.train.problem import (base_triple, make_batch,
                                             make_fused_value_and_grad, make_loss_fn)

    resolve_device()                # raises when there is no card
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pin_full_f32()
    _build.build_all()              # once, before the ranks start
    cfg = EXPERIMENTS["gpe2d_ground_state"]
    spec = cfg.spec
    batch = make_batch(spec, 0, device=dev)
    params = init_mlp(spec.layers, "xavier_uniform",
                      generator=torch.Generator().manual_seed(0), device=dev)
    pre, _ = pretrain_to_base(params, batch["x"], base_triple(spec, 0, batch["x"]).value,
                              spec.activation, epochs=PRETRAIN, lr=1e-3)
    with torch.no_grad():
        pre_scale = cfg.perturb_const / float(torch.max(mlp_apply(pre, batch["x"],
                                                                  spec.activation)))
    n = batch["x"].shape[0]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1)).to(dev)
    reordered = {k: v[perm].contiguous() if v.shape[:1] == (n,) else v
                 for k, v in batch.items()}

    def as_np(p):
        return [(w.cpu().numpy(), b.cpu().numpy()) for w, b in p]

    starts = {"random_g5": (params, GAMMA, SCALE), "pretrained_g0": (pre, 0.0, pre_scale),
              "pretrained_g5": (pre, GAMMA, pre_scale)}
    steps = {"relaxed": None, "exact": False}
    walks = {"pretrained_relaxed": ("pretrained_g5", None, {}, 1e-3),
             "pretrained_corrector": ("pretrained_g5", None, CORRECTORS, 1e-3),
             "pretrained_exact": ("pretrained_g5", False, {}, 1e-3),
             "random_relaxed": ("random_g5", None, {}, 1e-6),
             "random_corrector": ("random_g5", None, CORRECTORS, 1e-6),
             "random_exact": ("random_g5", False, {}, 1e-6)}
    fit_kw = dict(spec=spec, epochs=STEPS, check_every=STEPS, fused=True, lr=cfg.lr)
    cases = [(f"{s}_{m}", "fit", dict(params=as_np(p), gamma=g, scale=sc, relaxed=r,
                                      **fit_kw))
             for s, (p, g, sc) in starts.items() for m, r in steps.items()]
    cases += [(w, "vag", dict(spec=spec, params=as_np(starts[s][0]), gamma=starts[s][1],
                              scale=starts[s][2], relaxed=r, steps=4, lr=lr, **kw))
              for w, (s, r, kw, lr) in walks.items()]
    cases.append(("fault", case_fit_local_count,
                  dict(params=as_np(pre), gamma=GAMMA, scale=pre_scale, **fit_kw)))
    ranks = run_cases(cases, nprocs=2, backend="gloo")
    r = ranks[0]

    def unsharded(p, g, sc, relaxed, b):
        return fit(make_loss_fn(spec), make_optimizer("adam", cfg.lr, clip_norm=1.0), p, b,
                   g, sc, epochs=STEPS, tol=0.0, patience=10 ** 9, check_every=STEPS,
                   value_and_grad_fn=make_fused_value_and_grad(spec, device=dev,
                                                               relaxed=relaxed))

    refs = {}
    for s, (p, g, sc) in starts.items():
        for m, relaxed in steps.items():
            label = f"{s}_{m}"
            ref = refs[label] = unsharded(p, g, sc, relaxed, batch)
            alt = unsharded(p, g, sc, relaxed, reordered)
            row = {"row": "reordered", "start": s, "step": m, "best_loss": ref.best_loss,
                   "mu_best": ref.mu_best}
            for name, best, mu, hist in (
                    ("sharded", r[f"{label}/best_loss"], r[f"{label}/mu_best"],
                     r[f"{label}/loss_history"]),
                    ("reordered", alt.best_loss, alt.mu_best, alt.loss_history)):
                row[name] = {"best_loss": _rel(best, ref.best_loss),
                             "mu_best": _rel(mu, ref.mu_best),
                             "first_step_off_1e-4": _first_off(hist, ref.loss_history)}
            print(json.dumps(row, default=float), flush=True)

    for w, (s, relaxed, kw, lr) in walks.items():
        p, g, sc = starts[s]

        def one(b):
            vag = make_fused_value_and_grad(spec, device=dev, relaxed=relaxed, **kw)
            return walk(vag, p, b, g, sc, steps=4, lr=lr)

        want, alt = one(batch), one(reordered)
        got = {k: r[f"{w}/{k}"] for k in ("total", "grads", "state") if f"{w}/{k}" in r}
        row = {"row": "conditioning", "walk": w, "lr": lr, "total": want["total"].tolist()}
        for name, x in (("sharded", got), ("reordered", alt)):
            row[name] = {"total": _rel(x["total"], want["total"]),
                         "grads": [_grad_err(a, b, spec.layers)
                                   for a, b in zip(x["grads"], want["grads"])],
                         "state": (np.max(_rel(x["state"], want["state"]), axis=1).tolist()
                                   if "state" in want else None)}
        print(json.dumps(row, default=float), flush=True)

    ref = refs["pretrained_g5_relaxed"]
    k = 10
    print(json.dumps({
        "row": "fault", "start": "pretrained_g5", "step": "relaxed",
        "first_steps": max(max(_rel(r["fault/loss_history"][:k], ref.loss_history[:k])),
                           max(_rel(r["fault/mu_history"][:k], ref.mu_history[:k]))),
        "best_loss": _rel(r["fault/best_loss"], ref.best_loss),
        "mu_best": _rel(r["fault/mu_best"], ref.mu_best),
        "first_step_off_1e-4": _first_off(r["fault/loss_history"], ref.loss_history)},
        default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
