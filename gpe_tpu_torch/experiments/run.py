"""CLI experiment runner, port of `gpe_tpu/experiments/run.py`'s `plpinn`
branch:

    python -m gpe_tpu_torch.experiments.run <name> [--train] [--epochs N]
        [--gammas G ...] [--modes M ...] [--pretrain N] [--seed S]
        [--lm-steps N] [--out DIR] [--cpu] [--list]

Train-or-load the bundle `<out>/<name>/bundle.pkl` (`--train` forces a fresh
run), run `train_plpinn` with the config's `rebase` and `lm_polish`, score a
2D harmonic run's LM-polished μ against the imaginary-time oracle (384²
grid, τ 2e-3, Richardson order 2), write `<out>/<name>/summary.json` and
print one JSON line with the JAX record's keys (`experiment`,
`mu_table_tail`, `lm_polished` with `mu_ref`/`mu_abs_err`, `wall_s`) plus
`seconds`, the wall time of each part (pretrain, each γ rung's fit, LM,
oracle), and on the card `launches`, the f32 K1 and K2 launches of the run
(`kernels.fused_residual.collocation_sums.launches`,
`kernels.fused_grad.collocation_grads.launches`).

`--out` defaults to `runs_torch`; the port never writes under `runs/`,
which holds the JAX package's artifacts. The run is on the CUDA card unless
`--cpu` is given. A failing oracle fails the run. Plots are left out (the
JAX runner's `viz/` suite is not ported). Configurations of the JAX
registry the port cannot build yet, and the other algorithms, raise
NotImplementedError naming what they wait for.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ORACLE_GRID = 384
ORACLE_TAU = 2e-3
ORACLE_RICHARDSON = 2


def _emit(out_dir, record):
    """Print the run's JSON record and persist it as <out_dir>/summary.json."""
    print(json.dumps(record, default=str))
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(record, f, indent=2, default=str)


def oracle_mu(spec, gamma: float, device=None) -> float:
    """μ of the 2D harmonic trap of `spec` at γ by the imaginary-time oracle
    at the runner's settings (384² grid over [lb, ub]², τ 2e-3, Richardson
    order 2), in float64 on `device`."""
    import numpy as np

    from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe

    a = dict(spec.potential_kwargs).get("a", 1.0)
    x1 = np.linspace(spec.lb, spec.ub, ORACLE_GRID)
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    mu, _ = imaginary_time_gpe(a * (X**2 + Y**2), x1[1] - x1[0], float(gamma),
                               kinetic=spec.kinetic, p=spec.p, tau=ORACLE_TAU,
                               richardson=ORACLE_RICHARDSON, device=device)
    return float(mu)


def _scored(spec) -> bool:
    return spec.dim == 2 and spec.potential == "harmonic" and not spec.hard_bc


def main(argv=None):
    ap = argparse.ArgumentParser(description="gpe_tpu_torch experiment runner")
    ap.add_argument("name", help="experiment name (see --list)")
    ap.add_argument("--list", action="store_true", help="list experiments and exit")
    ap.add_argument("--train", action="store_true", help="force fresh training")
    ap.add_argument("--out", default="runs_torch", help="output directory")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--modes", type=int, nargs="*", default=None)
    ap.add_argument("--gammas", type=float, nargs="*", default=None)
    ap.add_argument("--pretrain", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--lm-steps", type=int, default=120,
                    help="LM polish steps of an lm_polish config (default 120)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from gpe_tpu_torch.experiments.configs import EXPERIMENTS, WAITING

    if args.name == "list" or args.list:
        for k, v in EXPERIMENTS.items():
            print(f"{k:32s} algo={v.algorithm:10s} modes={v.modes} "
                  f"γ∈[{v.gamma_values[0]:g},{v.gamma_values[-1]:g}]×{len(v.gamma_values)}")
        return 0
    if args.name in WAITING:
        raise NotImplementedError(
            f"experiment {args.name!r} waits for {WAITING[args.name]}, not ported yet")
    if args.name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {args.name!r}; have {sorted(EXPERIMENTS)}")

    from gpe_tpu_torch.device import resolve_device
    from gpe_tpu_torch.io import load_bundle, save_bundle
    from gpe_tpu_torch.kernels import fused_grad, fused_residual
    from gpe_tpu_torch.train import train_plpinn

    cfg = EXPERIMENTS[args.name]
    for field, value in (("epochs", args.epochs), ("pretrain_epochs", args.pretrain),
                         ("seed", args.seed)):
        if value is not None:
            cfg = dataclasses.replace(cfg, **{field: value})
    if args.modes is not None:
        cfg = dataclasses.replace(cfg, modes=tuple(args.modes))
    if args.gammas is not None:
        cfg = dataclasses.replace(cfg, gamma_values=tuple(args.gammas))
    if cfg.algorithm != "plpinn":
        raise NotImplementedError(f"algorithm {cfg.algorithm!r} is not ported yet; "
                                  "see gpe_tpu.experiments.run")
    dev = resolve_device("cpu" if args.cpu else None)

    out_dir = os.path.join(args.out, cfg.name)
    os.makedirs(out_dir, exist_ok=True)
    bundle_path = os.path.join(out_dir, "bundle.pkl")
    kernels = {"fused_residual": fused_residual.collocation_sums,
               "fused_grad": fused_grad.collocation_grads}
    before = {k: fn.launches for k, fn in kernels.items()}
    t0 = time.time()
    polished, seconds = None, {}
    if args.train or not os.path.exists(bundle_path):
        res = train_plpinn(cfg.spec, cfg.gamma_values, cfg.modes,
                           epochs=cfg.epochs, tol=cfg.tol, patience=cfg.patience,
                           perturb_const=cfg.perturb_const, lr=cfg.lr,
                           seed=cfg.seed, pretrain_epochs=cfg.pretrain_epochs,
                           rebase=cfg.rebase, lm_polish=cfg.lm_polish,
                           lm_steps=args.lm_steps, verbose=True, device=dev)
        polished, seconds = res.polished, dict(res.seconds)
        save_bundle(bundle_path, res, cfg.spec)
    bundle = load_bundle(bundle_path)
    extra = {}
    if polished:
        extra["lm_polished"] = {
            m: {k: v for k, v in pol.items() if k not in ("params", "base_val")}
            for m, pol in polished.items()}
        if _scored(cfg.spec):
            seconds["oracle"] = {}
            for m, pol in extra["lm_polished"].items():
                t1 = time.perf_counter()
                pol["mu_ref"] = oracle_mu(cfg.spec, pol["gamma"], device=dev)
                pol["mu_abs_err"] = abs(pol["mu"] - pol["mu_ref"])
                seconds["oracle"][m] = time.perf_counter() - t1
                print(f"mode {m}: oracle μ_ref={pol['mu_ref']:.12f} "
                      f"({seconds['oracle'][m]:.2f} s), |μ − μ_ref| = "
                      f"{pol['mu_abs_err']:.3e}")
    record = {"experiment": cfg.name,
              "mu_table_tail": {str(m): v[-1] for m, v in bundle["mu_table"].items()},
              **extra,
              "wall_s": round(time.time() - t0, 1)}
    if seconds:
        record["seconds"] = seconds
    if dev.type == "cuda":
        record["launches"] = {k: fn.launches - before[k] for k, fn in kernels.items()}
    _emit(out_dir, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
