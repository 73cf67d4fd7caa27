"""BASELINE config #4 ground-state run, port of
`gpe_tpu/experiments/gpe2d_lattice_flagship.py`: the 2D optical lattice in a
Dirichlet box by the flagship recipe (gpe2d_flagship.py).

PL-PINN on a Hermite base converges to the localized single-well branch
(lattice_summary.py), so this run takes the spectral-flow distillation
solver (`train/spectral_flow.py`) with its DST-I Dirichlet kinetic
propagator: the lattice is non-confining, so the ψ = 0 box boundary is part
of the Hamiltonian. Each γ rung runs interleaved imaginary-time flow and
distillation, a float64 Richardson endgame, and a mesh-free LM polish of the
normalised residual. The net is first fitted (`pretrain_to_base`) to the
γ = 0 oracle state, cubic-interpolated to the collocation grid on the host
(scipy). μ is the net's, from its analytic forward-Laplacian derivatives,
scored against lattice_summary.py's independent 255² float64 oracle. No
fused kernel runs, as in the JAX package.

    python -m gpe_tpu_torch.experiments.gpe2d_lattice_flagship [--dir runs/gpe2d_lattice]
        [--out runs_torch/gpe2d_lattice] [--n 128] [--width 128]
        [--pretrain-epochs 3000] [--outer 120] [--inner 80] [--cpu]

Reads `<dir>/oracle_cache.npz`; merges the "ground_state" section into
`<out>/summary.json` (other sections kept; each row adds the solver calls'
`seconds`, the section the pretraining's and the device) and writes
`<out>/ground_state_params.pkl` (`io.save_params`). The run is on the CUDA
card unless `--cpu` is given; it never writes under `runs/`.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def oracle_seed(cache, lb: float, ub: float, xcol):
    """The cache's γ = 0 state (interior grid, ψ = 0 on the box's edge)
    cubic-interpolated to the points xcol (N, 2) on the host."""
    import numpy as np
    from scipy.interpolate import RegularGridInterpolator

    xi = np.asarray(cache["xi"])
    grid = np.concatenate([[lb], xi, [ub]])
    full = np.zeros((grid.size, grid.size))
    full[1:-1, 1:-1] = np.asarray(cache["psis"][0])
    return RegularGridInterpolator((grid, grid), full, method="cubic")(xcol)


def flow_spec(lb: float, ub: float, n: int = 128, width: int = 128):
    """The driver's spec: n² points, [2,width,width,width,1] shifted_tanh,
    the optical lattice V0 4, k π/4, kinetic 0.5, abs_power, the net alone
    (no perturbation base)."""
    from gpe_tpu_torch.train.problem import GPESpec

    return GPESpec(dim=2, lb=lb, ub=ub, n_points=n, layers=(2, width, width, width, 1),
                   activation="shifted_tanh", potential="optical_lattice",
                   potential_kwargs=(("V0", 4.0), ("k", 0.7853981633974483)),
                   basis="hermite", kinetic=0.5, nonlinearity="abs_power",
                   use_perturbation=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/gpe2d_lattice", help="read: oracle_cache.npz")
    ap.add_argument("--out", default="runs_torch/gpe2d_lattice",
                    help="write: summary.json, ground_state_params.pkl")
    ap.add_argument("--n", type=int, default=128, help="collocation side")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--pretrain-epochs", type=int, default=3000)
    ap.add_argument("--outer", type=int, default=120)
    ap.add_argument("--inner", type=int, default=80)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gpe_tpu_torch.device import pin_full_f32, resolve_device
    from gpe_tpu_torch.experiments.lattice_summary import merge_section
    from gpe_tpu_torch.io import save_params
    from gpe_tpu_torch.models import mlp
    from gpe_tpu_torch.train.pretrain import pretrain_to_base
    from gpe_tpu_torch.train.problem import make_batch
    from gpe_tpu_torch.train.spectral_flow import make_spectral_flow_solver

    # accuracy-critical: full-f32 GEMMs (the JAX driver's "highest")
    pin_full_f32()
    dev = resolve_device("cpu" if args.cpu else None)
    cache = np.load(os.path.join(args.dir, "oracle_cache.npz"))
    gammas = [float(g) for g in cache["gammas"]]
    xi, dxo = np.asarray(cache["xi"]), float(cache["dx"])
    lb, ub = float(xi[0] - dxo), float(xi[-1] + dxo)

    spec = flow_spec(lb, ub, args.n, args.width)
    batch = make_batch(spec, 0, device=dev)
    # warm start: the γ=0 oracle state interpolated to the collocation grid
    seed = oracle_seed(cache, lb, ub, batch["x"].cpu().numpy())

    params = mlp.init_mlp(spec.layers, generator=torch.Generator().manual_seed(0),
                          device=dev)
    t0 = time.time()
    params, pre_mse = pretrain_to_base(params, batch["x"],
                                       torch.as_tensor(seed, dtype=spec.dtype, device=dev),
                                       spec.activation, epochs=args.pretrain_epochs,
                                       lbfgs_steps=100)
    pretrain_s = time.time() - t0
    print(f"pretrain mse {pre_mse:.2e} ({pretrain_s:.0f}s)", flush=True)

    solver = make_spectral_flow_solver(spec, outer_steps=args.outer,
                                       inner_steps=args.inner, tau=2e-2,
                                       final_inner_steps=4000,
                                       final_lbfgs_steps=400,
                                       polish_steps=60, bc="dirichlet")
    rows = []
    for i, g in enumerate(gammas):
        t1 = time.time()
        res = solver(params, batch, g)
        seconds = [res.seconds]
        if i == 0:
            # the first rung starts from the coarse pretrained fit; a second
            # pass re-runs the distillation and polish from the converged
            # state (the JAX driver's recipe: at γ=0 the lattice problem is
            # linear, its lowest 9-well band near-degenerate, and more
            # passes do not improve the Rayleigh μ)
            res = solver(res.params, batch, g)
            seconds.append(res.seconds)
        params = res.params
        mu_ref = float(cache["mu_refs"][i])
        rows.append({"gamma": g, "mu_net": res.mu, "mu_grid": res.mu_grid,
                     "mu_ref": mu_ref, "abs_err": abs(res.mu - mu_ref),
                     "pde_loss": res.pde_loss,
                     "wall_s": round(time.time() - t1, 1), "seconds": seconds})
        print(json.dumps(rows[-1]), flush=True)

    section = {
        "note": "spectral-flow distillation with the DST-I Dirichlet "
                "propagator + mesh-free LM polish (the flagship recipe); "
                "μ from the net's analytic derivatives, scored vs the "
                "independent 255² f64 oracle",
        "rows": rows,
        "max_abs_err": max(r["abs_err"] for r in rows),
        "wall_s": round(time.time() - t0, 1),
        "pretrain_s": pretrain_s,
        "pretrain_mse": float(pre_mse),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    merge_section(os.path.join(args.out, "summary.json"), {"ground_state": section})
    save_params(os.path.join(args.out, "ground_state_params.pkl"), params)
    print(json.dumps({"max_abs_err": section["max_abs_err"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
