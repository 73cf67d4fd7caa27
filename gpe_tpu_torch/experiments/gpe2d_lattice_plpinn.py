"""BASELINE config #4 by the PL-PINN family itself, port of
`gpe_tpu/experiments/gpe2d_lattice_plpinn.py`: the optical lattice with a
numeric base (`physics/numeric.py`).

A Hermite (Gaussian) base leads PL-PINN to the localized single-well branch
(lattice_summary.py); the delocalized 3×3-well ground state needs a base of
its own. The γ = 0 linear eigenstate of the float64 Dirichlet DST-I oracle
becomes the base (its sine series gives spectrally exact value, ∇ and Δ),
and the PL machinery (q-scaled perturbation, rebased Δγ continuation, LM
polish at each cached γ) tracks the ground state along the γ ramp: the
oracle seeds only the γ = 0 linear state; every γ > 0 number is the net's
own continuation. Each fit step runs the fused kernels (K1 once a rung's
`init_state`, K2 once a step) on the card.

    python -m gpe_tpu_torch.experiments.gpe2d_lattice_plpinn [--dir runs/gpe2d_lattice]
        [--out runs_torch/gpe2d_lattice] [--epochs 4000] [--dgamma 0.5]
        [--lm-steps 300] [--polish-x64] [--cpu]

Reads `<dir>/oracle_cache.npz` (lattice_summary.py's; the committed JAX
cache by default). Merges the "plpinn_numeric_base" section into
`<out>/summary.json` (other sections kept); the section adds `seconds`
(pretrain, the fits, the rest: checkpoint polishes and rebases), the K1/K2
launches on the card and the device to the JAX keys. The JAX artifact ran
`--epochs 2500 --polish-x64`. The run is on the CUDA card unless `--cpu`
is given; it never writes under `runs/`.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def lattice_base(cache):
    """The γ = 0 oracle state of `cache` (oracle_cache.npz) as a sine series,
    and the box (lb, ub) its interior grid belongs to."""
    import numpy as np

    from gpe_tpu_torch.physics.numeric import SineSeries2D

    xi, dx = np.asarray(cache["xi"]), float(cache["dx"])
    lb, ub = float(xi[0] - dx), float(xi[-1] + dx)
    return SineSeries2D(xi, np.asarray(cache["psis"][0]), lb, ub), lb, ub


def lattice_spec(basis: str, lb: float, ub: float):
    """The driver's spec: 128² points, [2,128,128,128,1] shifted_tanh, the
    optical lattice V0 4, k π/4, kinetic 0.5, abs_power, on `basis`."""
    from gpe_tpu_torch.train.problem import GPESpec

    return GPESpec(dim=2, lb=lb, ub=ub, n_points=128,
                   layers=(2, 128, 128, 128, 1), activation="shifted_tanh",
                   potential="optical_lattice",
                   potential_kwargs=(("V0", 4.0), ("k", 0.7853981633974483)),
                   basis=basis, kinetic=0.5, nonlinearity="abs_power")


def train(spec, ramp, checkpoints, epochs: int, lm_steps: int, polish_x64: bool,
          device, verbose: bool = True):
    """The driver's train_plpinn call (rebased ramp, LM at each checkpoint
    γ); returns (the PLPINNResult, K1/K2 launches on the card, wall s)."""
    from gpe_tpu_torch.kernels._common import LaunchCounter
    from gpe_tpu_torch.train.plpinn import train_plpinn

    launches = LaunchCounter()
    t0 = time.time()
    res = train_plpinn(spec, ramp, modes=(0,), epochs=epochs, tol=0.0,
                       patience=10**9, rebase=True, keep_params=False,
                       polish_checkpoints=checkpoints, lm_steps=lm_steps,
                       polish_x64=polish_x64, verbose=verbose, device=device)
    return res, launches.since(), time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/gpe2d_lattice", help="read: oracle_cache.npz")
    ap.add_argument("--out", default="runs_torch/gpe2d_lattice", help="write: summary.json")
    ap.add_argument("--epochs", type=int, default=4000)
    ap.add_argument("--dgamma", type=float, default=0.5)
    ap.add_argument("--lm-steps", type=int, default=300)
    ap.add_argument("--polish-x64", action="store_true",
                    help="f64 LM endgame + f64 μ at each checkpoint")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gpe_tpu_torch.device import resolve_device
    from gpe_tpu_torch.experiments.lattice_summary import merge_section
    from gpe_tpu_torch.physics.numeric import register_numeric_basis

    dev = resolve_device("cpu" if args.cpu else None)
    cache = np.load(os.path.join(args.dir, "oracle_cache.npz"))
    gammas = [float(g) for g in cache["gammas"]]
    # γ=0 linear eigenstate only — the continuation must earn every γ>0 state
    series, lb, ub = lattice_base(cache)
    spec = lattice_spec(register_numeric_basis("lattice_gs", series), lb, ub)

    gmax = gammas[-1]
    n_steps = int(round(gmax / args.dgamma))
    ramp = [k * args.dgamma for k in range(n_steps + 1)]
    res, launches, wall = train(spec, ramp, gammas, args.epochs, args.lm_steps,
                                args.polish_x64, dev)

    mu = dict(res.mu_table[0])
    polished = (res.polished.get(0, {}) or {}).get("by_gamma", {})
    rows = []
    for i, g in enumerate(gammas):
        mu_ref = float(cache["mu_refs"][i])
        rows.append({"gamma": g, "mu_pl": mu[g], "mu_pl_lm": polished.get(g),
                     "mu_ref": mu_ref,
                     "abs_err_pl": abs(mu[g] - mu_ref),
                     "abs_err_pl_lm": (abs(polished[g] - mu_ref)
                                       if g in polished else None)})
        print(json.dumps(rows[-1]), flush=True)

    pretrain_s = sum(res.seconds["pretrain"].values())
    fit_s = sum(res.seconds["fit"].get(0, {}).values())
    section = {
        "note": "PL-PINN-R with the numeric sine-series base "
                "(physics/numeric.py): γ=0 linear Dirichlet eigenstate as "
                "base, q-scaled perturbation + rebased Δγ=%g continuation + "
                "per-checkpoint LM polish — the PL family reaching the "
                "DELOCALIZED lattice ground state that the hermite base "
                "cannot (branch analysis above)" % args.dgamma,
        "rows": rows,
        "max_abs_err_pl_lm": max(r["abs_err_pl_lm"] for r in rows
                                 if r["abs_err_pl_lm"] is not None),
        "epochs_per_gamma": args.epochs,
        "wall_s": round(wall, 1),
        "seconds": {"pretrain": pretrain_s, "fits": fit_s,
                    "polishes_and_rest": wall - pretrain_s - fit_s,
                    "fit_per_gamma": {str(g): s for g, s in
                                      res.seconds["fit"].get(0, {}).items()}},
        "launches": launches,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    merge_section(os.path.join(args.out, "summary.json"), {"plpinn_numeric_base": section})
    print(json.dumps({"max_abs_err_pl_lm": section["max_abs_err_pl_lm"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
