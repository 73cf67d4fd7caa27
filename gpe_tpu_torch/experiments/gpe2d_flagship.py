"""Flagship run, port of `gpe_tpu/experiments/gpe2d_flagship.py` — BASELINE
config #3: the 2D GPE ground state in a harmonic trap, β(γ) = 100, 224²
collocation points. Target: |μ − μ_ref| < 1e-3.

Pipeline: pretrain the net to the linear ground state → γ continuation with
the spectral-flow distillation solver (`train/spectral_flow.py`) → the
mesh-free μ (the net's analytic derivatives) and the grid μ of the f64
endgame, against the float64 imaginary-time oracle on a 384² grid.

    python -m gpe_tpu_torch.experiments.gpe2d_flagship [--n 224] [--width 128]
        [--gammas G ...] [--outer 200] [--inner 80] [--out DIR] [--cpu]
    python -m gpe_tpu_torch.experiments.gpe2d_flagship --plots [--out DIR]

Writes `<out>/params.pkl` (`io.save_params`) and `<out>/summary.json` with
the JAX run's keys ({"ramp", "summary"}); each rung's record adds
`seconds` (interleave, endgame, distill, polish, report) and the summary
adds `seconds` (pretrain, ramp, oracle), the device and `plot`. The net's
ψ on the training grid goes to `<out>/flagship_solution.npz`, from which
`flagship_solution.png` is drawn where matplotlib is installed (`plot`
lists it, or names the `--plots` command that draws it on another host).
The run is on the CUDA card unless `--cpu` is given; `--out` defaults to
`runs_torch/gpe2d_flagship`.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from gpe_tpu_torch import viz


def psi_errors(params, spec, x1, psi_ref):
    """Wavefunction errors of the net against the oracle's grid state: the
    net evaluated on the oracle's (finer) grid, L2-normalised with the grid
    measure, sign-aligned; returns (‖ψ_net − ψ_ref‖_L2, max|Δψ|)."""
    import torch

    from gpe_tpu_torch.models import mlp

    n = x1.size
    dx = float(x1[1] - x1[0])
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    w = params[0][0]
    xy = torch.as_tensor(np.stack([X.ravel(), Y.ravel()], -1), dtype=w.dtype,
                         device=w.device)
    with torch.no_grad():
        u = mlp.mlp_apply(params, xy, spec.activation)
    u = u.double().cpu().numpy().reshape(n, n)
    u = u / np.sqrt(np.sum(u * u) * dx * dx)
    ref = np.asarray(psi_ref.cpu() if torch.is_tensor(psi_ref) else psi_ref,
                     dtype=np.float64)
    if np.sum(u * ref) < 0:
        u = -u
    diff = u - ref
    return float(np.sqrt(np.sum(diff * diff) * dx * dx)), float(np.max(np.abs(diff)))


def draw_flagship_solution(out_dir: str, plots) -> list:
    """flagship_solution.png (|ψ| on the training grid) from
    `<out_dir>/flagship_solution.npz`."""
    d = np.load(viz.saved(os.path.join(out_dir, "flagship_solution.npz")))
    return [plots.plot_solution_2d(d["xy"], d["u"], out_dir, "flagship_solution.png")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=224, help="grid side (n² points)")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--gammas", type=float, nargs="*",
                    default=[2.0, 5.0, 10.0, 20.0, 35.0, 50.0, 70.0, 100.0])
    ap.add_argument("--outer", type=int, default=200)
    ap.add_argument("--inner", type=int, default=80)
    ap.add_argument("--out", default="runs_torch/gpe2d_flagship")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--plots", action="store_true",
                    help="draw the figure from <out>/flagship_solution.npz; run nothing")
    args = ap.parse_args(argv)
    if args.plots:
        viz.draw_saved(lambda plots: draw_flagship_solution(args.out, plots))
        return 0

    import torch

    from gpe_tpu_torch.device import pin_full_f32, resolve_device
    from gpe_tpu_torch.io import save_params
    from gpe_tpu_torch.models import mlp
    from gpe_tpu_torch.train.pretrain import pretrain_to_base
    from gpe_tpu_torch.train.problem import GPESpec, base_triple, make_batch
    from gpe_tpu_torch.train.spectral_flow import make_spectral_flow_solver
    from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe

    # the accuracy path runs its GEMMs in full f32 (the JAX driver's
    # "highest" matmul precision)
    pin_full_f32()
    dev = resolve_device("cpu" if args.cpu else None)
    spec = GPESpec(dim=2, n_points=args.n, layers=(2, args.width, args.width, args.width, 1),
                   potential="harmonic", potential_kwargs=(("a", 0.5),),
                   kinetic=0.5, lb=-8.0, ub=8.0, use_perturbation=False,
                   basis="hermite", nonlinearity="abs_power")
    batch = make_batch(spec, 0, device=dev)
    params = mlp.init_mlp(spec.layers, generator=torch.Generator().manual_seed(0),
                          device=dev)
    base = base_triple(GPESpec(dim=2, n_points=args.n, lb=-8.0, ub=8.0, basis="hermite"),
                       0, batch["x"])
    t0 = time.time()
    params, pre_mse = pretrain_to_base(params, batch["x"], base.value, spec.activation,
                                       epochs=3000, lbfgs_steps=100)
    seconds = {"pretrain": time.time() - t0}
    print(f"pretrain mse {pre_mse:.2e} ({seconds['pretrain']:.0f}s)", flush=True)

    solver = make_spectral_flow_solver(spec, outer_steps=args.outer,
                                       inner_steps=args.inner, tau=2e-2,
                                       final_inner_steps=4000,
                                       final_lbfgs_steps=400, polish_steps=60)
    results = []
    t1 = time.time()
    for g in args.gammas:
        t2 = time.time()
        res = solver(params, batch, g)
        params = res.params
        results.append({"gamma": g, "mu_net": res.mu, "mu_grid": res.mu_grid,
                        "pde_loss": res.pde_loss, "wall_s": round(time.time() - t2, 1),
                        "seconds": res.seconds})
        print(json.dumps(results[-1]), flush=True)
    seconds["ramp"] = time.time() - t1

    # float64 oracle on a finer grid
    t1 = time.time()
    gmax = args.gammas[-1]
    x1 = np.linspace(-8, 8, 384)
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    mu_ref, psi_ref = imaginary_time_gpe(0.5 * (X**2 + Y**2), x1[1] - x1[0], gmax,
                                         kinetic=0.5, tau=2e-3, richardson=True,
                                         device=dev)
    seconds["oracle"] = time.time() - t1
    psi_l2, psi_max = psi_errors(params, spec, x1, psi_ref)
    summary = {
        "config": "BASELINE#3 2D GPE beta=100 ~50k pts",
        "n_points": args.n ** 2,
        "gamma": gmax,
        "mu_net": results[-1]["mu_net"],
        "mu_grid": results[-1]["mu_grid"],
        "mu_ref": mu_ref,
        "abs_err_net": abs(results[-1]["mu_net"] - mu_ref),
        "abs_err_grid": abs(results[-1]["mu_grid"] - mu_ref),
        "psi_l2_err": psi_l2,
        "psi_max_err": psi_max,
        "target": 1e-3,
        "total_wall_s": round(time.time() - t0, 1),
        "seconds": seconds,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    os.makedirs(args.out, exist_ok=True)
    with torch.no_grad():
        u = mlp.mlp_apply(params, batch["x"], spec.activation)
    np.savez(os.path.join(args.out, "flagship_solution.npz"),
             xy=batch["x"].cpu().numpy(), u=u.cpu().numpy())
    summary["plot"] = viz.draw(
        lambda plots: draw_flagship_solution(args.out, plots),
        f"python -m gpe_tpu_torch.experiments.gpe2d_flagship --plots --out {args.out}")
    print(json.dumps(summary), flush=True)

    save_params(os.path.join(args.out, "params.pkl"), params)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"ramp": results, "summary": summary}, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
