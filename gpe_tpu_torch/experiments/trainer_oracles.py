"""Oracle errors of the continuation and excited-state runs:

    python -m gpe_tpu_torch.experiments.trainer_oracles <name> [run.py options]

trains `<name>` through the runner (`experiments/run.py <name> --train`
with the options given, e.g. `--epochs`, `--out`), then prints one JSON
line that scores each μ of its table against an oracle:

- a β sweep of the gravity well (linear potential, γ = 0): the exact
  μₙ(β) = (c·β²)^(1/3)·|αₙ| of −c·u″ + β·x·u = μ·u on the half line, αₙ
  the n-th zero of Ai (the domain [0, 35] is wide enough that its far wall
  does not move these digits);
- a 1D deflation run: μ of each deflated state against the float64 Newton
  oracle `validate.fdm.solve_gpe_excited_1d` of the same node count, on
  the config's collocation grid, and against the nearest μ of the
  oracle's ladder (deflation need not find the states in order).

Other configurations raise ValueError.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def gravity_well_mu(beta: float, mode: int = 0, kinetic: float = 1.0) -> float:
    """Exact μₙ of −c·u″ + β·x·u = μ·u, u(0) = 0, u → 0 at infinity."""
    from gpe_tpu_torch.physics.bases import airy_zero

    return (kinetic * beta * beta) ** (1.0 / 3.0) * abs(airy_zero(mode))


def deflation_oracle(spec, gamma: float, n_modes: int, device=None) -> list:
    """μ of the lowest n_modes states of a 1D spec at γ by the float64
    Newton oracle on the spec's collocation grid."""
    import torch

    from gpe_tpu_torch.physics import potentials
    from gpe_tpu_torch.validate.fdm import solve_gpe_excited_1d

    if spec.dim != 1:
        raise ValueError("the excited-state oracle is 1D")
    x = np.linspace(spec.lb, spec.ub, spec.n_points)
    V = potentials.get_potential(spec.potential, **dict(spec.potential_kwargs))(
        torch.as_tensor(x)).numpy()
    return [float(solve_gpe_excited_1d(V, x[1] - x[0], gamma, n, kinetic=spec.kinetic,
                                       p=spec.p, nonlinearity=spec.nonlinearity,
                                       device=device)[0])
            for n in range(n_modes)]


def score(cfg, out_dir: str, device=None) -> list:
    """[{β or mode, mu, mu_ref, abs_err}] of the run of `cfg` written under
    out_dir (the runner's bundle or summary)."""
    if cfg.algorithm == "beta_sweep" and cfg.spec.potential == "linear" \
            and cfg.gamma_values[0] == 0.0:
        from gpe_tpu_torch.io import load_bundle

        bundle = load_bundle(os.path.join(out_dir, "bundle.pkl"))
        rows = []
        for mode, table in bundle["mu_table"].items():
            for beta, mu in table:
                ref = gravity_well_mu(beta, mode, cfg.spec.kinetic)
                rows.append({"mode": mode, "beta": beta, "mu": mu, "mu_ref": ref,
                             "abs_err": abs(mu - ref)})
        return rows
    if cfg.algorithm == "deflation":
        with open(os.path.join(out_dir, "summary.json")) as f:
            table = json.load(f)["mu_table"]
        refs = deflation_oracle(cfg.spec, cfg.gamma_values[0], len(table), device)
        rows = []
        for (n, mu), ref in zip(table, refs):
            # deflation need not find the states in the oracle's order
            near = int(np.argmin([abs(mu - r) for r in refs]))
            rows.append({"mode": n, "mu": mu, "mu_ref": ref, "abs_err": abs(mu - ref),
                         "nearest_mode": near, "nearest_abs_err": abs(mu - refs[near])})
        return rows
    raise ValueError(f"no oracle for {cfg.name!r}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from gpe_tpu_torch.experiments import run
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("name")
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--cpu", action="store_true")
    known, _ = ap.parse_known_args(argv)
    cfg = EXPERIMENTS[known.name]
    if run.main(argv + ["--train"]) != 0:
        return 1
    rows = score(cfg, os.path.join(known.out, known.name),
                 device="cpu" if known.cpu else None)
    print(json.dumps({"experiment": known.name, "oracle": rows,
                      "max_abs_err": max(r["abs_err"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
