"""Probe of `gpe2d_lattice_plpinn`'s checkpoint polishes: the driver's
`train_plpinn` call on the numeric lattice base, ramped to `--gmax` with
LM checkpoints at 0 and `--gmax`, each LM run's record printed as one JSON
line (steps, losses, accepted steps, λ), then the μ table. The fit's route
is the environment's (`GPE_TPU_TORCH_NO_RELAXED=1`: the exact K2 step, K1
every step; `GPE_TPU_TORCH_NO_FUSED=1`: autograd), so the routes can be
compared at the point where the port's continuation and JAX's part.

    python -m gpe_tpu_torch.experiments.lattice_lm_probe [--gmax 5] [--epochs 2500]
        [--dgamma 0.5] [--lm-steps 300] [--polish-x64] [--dir runs/gpe2d_lattice] [--cpu]

Writes nothing; runs on the CUDA card unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os


def lm_record(res, gamma, dtype) -> dict:
    """One LM run's summary: losses, accepted steps (a step is accepted
    where the loss fell), λ."""
    import numpy as np

    h = np.asarray(res.loss_history, np.float64)
    lam = np.asarray(res.lam_history, np.float64)
    return {"gamma": float(gamma), "dtype": str(dtype), "steps": int(h.size),
            "loss_first": float(h[0]), "loss_last": float(h[-1]),
            "accepted": int(np.sum(np.diff(h) < 0)),
            "lam_min": float(lam.min()), "lam_last": float(lam[-1])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/gpe2d_lattice", help="read: oracle_cache.npz")
    ap.add_argument("--gmax", type=float, default=5.0)
    ap.add_argument("--dgamma", type=float, default=0.5)
    ap.add_argument("--epochs", type=int, default=2500)
    ap.add_argument("--lm-steps", type=int, default=300)
    ap.add_argument("--polish-x64", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    import numpy as np

    from gpe_tpu_torch.device import resolve_device
    from gpe_tpu_torch.experiments import gpe2d_lattice_plpinn as lp
    from gpe_tpu_torch.physics.numeric import register_numeric_basis
    from gpe_tpu_torch.train import gauss_newton

    dev = resolve_device("cpu" if args.cpu else None)
    cache = np.load(os.path.join(args.dir, "oracle_cache.npz"))
    series, lb, ub = lp.lattice_base(cache)
    spec = lp.lattice_spec(register_numeric_basis("lattice_gs", series), lb, ub)
    ramp = [k * args.dgamma for k in range(int(round(args.gmax / args.dgamma)) + 1)]

    make = gauss_newton.make_lm_solver

    def recording(*a, **kw):
        solver = make(*a, **kw)

        def call(params, batch, gamma, scale):
            res = solver(params, batch, gamma, scale)
            print(json.dumps(lm_record(res, gamma, batch["x"].dtype)), flush=True)
            return res
        return call

    gauss_newton.make_lm_solver = recording
    try:
        res, launches, wall = lp.train(spec, ramp, [0.0, ramp[-1]], args.epochs,
                                       args.lm_steps, args.polish_x64, dev, verbose=False)
    finally:
        gauss_newton.make_lm_solver = make
    print(json.dumps({"route": {k: os.environ.get(f"GPE_TPU_TORCH_{k}")
                                for k in ("NO_RELAXED", "NO_FUSED")},
                      "mu_table": res.mu_table[0],
                      "polished": {str(g): m for g, m in res.polished[0]["by_gamma"].items()},
                      "launches": launches, "wall_s": wall}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
