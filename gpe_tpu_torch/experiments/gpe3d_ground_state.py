"""3D GPE ground state, port of `gpe_tpu/experiments/gpe3d_ground_state.py`:

  −½Δψ + ½|x|²ψ + γ|ψ|^(p−1)ψ = μψ  on [−6,6]³,  ∫|ψ|² = 1,  γ ramp 0 → 100.

Pipeline (the recipe of the 2D flagship, `gpe2d_flagship`):
  1. the float64 split-step imaginary-time oracle on a 64³ grid (on the
     device), γ-ladder warm-started, Richardson-extrapolated in τ; one 80³
     confirmation at the final γ bounds the grid error. Cached to
     `<out>/oracle_cache.npz` after every rung (a run resumes the longest
     cached prefix of its ladder).
  2. pretrain the vanilla net to the linear Hermite-product ground state,
     then the γ continuation with the spectral-flow distillation solver
     (`train/spectral_flow.py`) at 36³ grid points, an LM polish per rung.
Reports the mesh-free μ and the grid μ per rung against the oracle ladder,
the ψ errors on the training grid at the final γ (the oracle's ψ regridded
by scipy's cubic RegularGridInterpolator on the host), the Thomas–Fermi
anchor and the wall time.

    python -m gpe_tpu_torch.experiments.gpe3d_ground_state [--n 36]
        [--width 128] [--gammas G ...] [--outer 200] [--inner 80]
        [--oracle-n 64] [--oracle-confirm-n 80] [--lm-steps 60] [--seed 0]
        [--out DIR] [--cpu]
    python -m gpe_tpu_torch.experiments.gpe3d_ground_state --plots [--out DIR]
    CPU smoke: ... --cpu --n 16 --width 48 --outer 60 --inner 50 --gammas 0 5 \
               --oracle-n 32 --oracle-confirm-n 48

Writes `<out>/summary.json` (the JAX run's keys; each rung adds `seconds`,
the summary `seconds`, the device and `plot`) and `<out>/params.pkl`. The
net's midplane slice ψ(x, y, z_mid) goes to `<out>/midplane_z0.npz`, from
which `midplane_z0.png` is drawn where matplotlib is installed (`plot`
lists it, or names the `--plots` command that draws it on another host).
On the CUDA card unless `--cpu`; `--out` defaults to
`runs_torch/gpe3d_ground_state`.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from gpe_tpu_torch import viz

OUT = "runs_torch/gpe3d_ground_state"


def _oracle(gammas, n: int, lb: float, ub: float, cache_path: str,
            confirm_n: int = 80, verbose: bool = True,
            tau: float = 4e-3, richardson: int = 1, rich_final: int = 2,
            device=None):
    """γ-laddered f64 split-step oracle on `device`: ({γ: μ*}, the final
    γ's ψ on the n³ grid as numpy, the grid-error bound).

    Each rung warm-starts from the previous converged state. Ramp rungs get
    Richardson order `richardson`, the final γ order `rich_final`; the
    confirm_n run at the final γ bounds the spatial discretisation error."""
    from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe

    gam = [float(g) for g in gammas]
    mus, psi, grid_err = {}, None, float("nan")
    if os.path.exists(cache_path):
        # resume from the longest cached prefix of the requested ladder
        d = np.load(cache_path, allow_pickle=True)
        if int(d["n"]) == n:
            cached, cmus = list(d["gammas"]), list(d["mus"])
            k = 0
            while k < min(len(cached), len(gam)) and float(cached[k]) == gam[k]:
                k += 1
            if k:
                mus = {float(g): float(m) for g, m in zip(cached[:k], cmus[:k])}
                psi = np.asarray(d["psi_final"])
                grid_err = float(d["grid_err_bound"])
                if k == len(gam) and (confirm_n in (None, n) or not np.isnan(grid_err)):
                    return mus, psi, grid_err

    def grid(m):
        x1 = np.linspace(lb, ub, m)
        X, Y, Z = np.meshgrid(x1, x1, x1, indexing="ij")
        return x1, 0.5 * (X * X + Y * Y + Z * Z)

    def save():
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        done = [g for g in gam if g in mus]
        np.savez(cache_path, gammas=np.asarray(done),
                 mus=np.asarray([mus[g] for g in done]),
                 psi_final=psi, n=n, grid_err_bound=grid_err)

    x1, V = grid(n)
    dx = x1[1] - x1[0]
    for g in gam:
        if g in mus:
            continue
        t0 = time.time()
        order = rich_final if g == gam[-1] else richardson
        mu, psi_t = imaginary_time_gpe(V, dx, g, kinetic=0.5, tau=tau,
                                       steps=20000, psi0=psi, tol=1e-10,
                                       richardson=order, device=device)
        mus[g], psi = float(mu), psi_t.cpu().numpy()
        save()
        if verbose:
            print(f"oracle γ={g:g}: μ*={mu:.7f} (order {order}, "
                  f"{time.time() - t0:.0f}s)", flush=True)
    if confirm_n and confirm_n != n and np.isnan(grid_err):
        xc, Vc = grid(confirm_n)
        mu_c, _ = imaginary_time_gpe(Vc, xc[1] - xc[0], gam[-1], kinetic=0.5, tau=tau,
                                     steps=20000, tol=1e-10,
                                     richardson=rich_final, device=device)
        grid_err = abs(mu_c - mus[gam[-1]])
        if verbose:
            print(f"oracle grid check: n={n} vs {confirm_n} at γ={gam[-1]:g}: "
                  f"|Δμ*| = {grid_err:.2e}", flush=True)
        save()
    return mus, psi, grid_err


def psi_errors_3d(psi_net_flat, x1, psi_ref):
    """‖ψ_net − ψ_ref‖_L2 and max|Δψ|, both states L2-normalised on the
    shared n³ grid and sign-aligned (the 3D twin of
    gpe2d_flagship.psi_errors)."""
    n = x1.size
    dx = float(x1[1] - x1[0])
    u = np.asarray(psi_net_flat, np.float64).reshape(n, n, n)
    u = u / np.sqrt(np.sum(u * u) * dx ** 3)
    ref = np.asarray(psi_ref, np.float64)
    ref = ref / np.sqrt(np.sum(ref * ref) * dx ** 3)
    if np.sum(u * ref) < 0:
        u = -u
    diff = u - ref
    return float(np.sqrt(np.sum(diff * diff) * dx ** 3)), float(np.max(np.abs(diff)))


def draw_midplane(out_dir: str, plots) -> list:
    """midplane_z0.png (|ψ| on the z ≈ 0 slice of the training grid) from
    `<out_dir>/midplane_z0.npz`."""
    d = np.load(viz.saved(os.path.join(out_dir, "midplane_z0.npz")))
    return [plots.plot_solution_2d(d["pts"], d["u"], out_dir, "midplane_z0.png")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=36, help="grid side (n³ points)")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--gammas", type=float, nargs="*",
                    default=[0.0, 5.0, 10.0, 20.0, 35.0, 50.0, 70.0, 100.0])
    ap.add_argument("--outer", type=int, default=200)
    ap.add_argument("--inner", type=int, default=80)
    ap.add_argument("--oracle-n", type=int, default=64)
    ap.add_argument("--oracle-confirm-n", type=int, default=80)
    ap.add_argument("--lm-steps", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--plots", action="store_true",
                    help="draw the figure from <out>/midplane_z0.npz; run nothing")
    args = ap.parse_args(argv)
    if args.plots:
        viz.draw_saved(lambda plots: draw_midplane(args.out, plots))
        return 0

    import torch
    from scipy.interpolate import RegularGridInterpolator

    from gpe_tpu_torch.device import pin_full_f32, resolve_device
    from gpe_tpu_torch.io import save_params
    from gpe_tpu_torch.models import mlp
    from gpe_tpu_torch.physics.thomas_fermi import thomas_fermi_mu_3d_harmonic
    from gpe_tpu_torch.train.pretrain import pretrain_to_base
    from gpe_tpu_torch.train.problem import GPESpec, base_triple, make_batch
    from gpe_tpu_torch.train.spectral_flow import make_spectral_flow_solver

    # accuracy-critical fit (the rationale of gpe2d_flagship)
    pin_full_f32()
    dev = resolve_device("cpu" if args.cpu else None)
    spec = GPESpec(dim=3, lb=-6.0, ub=6.0, n_points=args.n,
                   layers=(3, args.width, args.width, args.width, 1),
                   potential="harmonic", potential_kwargs=(("a", 0.5),),
                   basis="hermite", kinetic=0.5, nonlinearity="abs_power",
                   use_perturbation=False)

    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    mus_ref, psi_ref, grid_err = _oracle(
        args.gammas, args.oracle_n, spec.lb, spec.ub,
        os.path.join(args.out, "oracle_cache.npz"), confirm_n=args.oracle_confirm_n,
        device=dev)
    seconds = {"oracle": time.time() - t0}

    batch = make_batch(spec, 0, device=dev)
    params = mlp.init_mlp(spec.layers, generator=torch.Generator().manual_seed(args.seed),
                          device=dev)
    base = base_triple(GPESpec(dim=3, lb=spec.lb, ub=spec.ub, n_points=args.n,
                               basis="hermite"), 0, batch["x"])
    t0 = time.time()
    params, pre_mse = pretrain_to_base(params, batch["x"], base.value, spec.activation,
                                       epochs=3000, lbfgs_steps=100)
    seconds["pretrain"] = time.time() - t0
    print(f"pretrain mse {pre_mse:.2e} ({seconds['pretrain']:.0f}s)", flush=True)

    solver = make_spectral_flow_solver(spec, outer_steps=args.outer,
                                       inner_steps=args.inner, tau=2e-2,
                                       final_inner_steps=4000,
                                       final_lbfgs_steps=400,
                                       polish_steps=args.lm_steps)
    rows = []
    for g in args.gammas:
        t1 = time.time()
        res = solver(params, batch, float(g))
        params = res.params
        rows.append({"gamma": float(g), "mu": res.mu, "mu_grid": res.mu_grid,
                     "mu_ref": mus_ref[float(g)],
                     "abs_err": abs(res.mu - mus_ref[float(g)]),
                     "pde_loss": res.pde_loss,
                     "wall_s": round(time.time() - t1, 1), "seconds": res.seconds})
        print(json.dumps(rows[-1]), flush=True)
    wall = time.time() - t0

    gmax = float(args.gammas[-1])
    mu_final = rows[-1]["mu"]
    # ψ reference: the grid-converged Richardson-2 oracle ψ (oracle-n³),
    # cubic-regridded onto the training grid on the host
    x1 = np.linspace(spec.lb, spec.ub, args.n)
    xo = np.linspace(spec.lb, spec.ub, args.oracle_n)
    interp = RegularGridInterpolator((xo,) * 3, np.asarray(psi_ref), method="cubic")
    Xg = np.stack(np.meshgrid(x1, x1, x1, indexing="ij"), -1).reshape(-1, 3)
    psi_ref_train = interp(Xg).reshape(args.n, args.n, args.n)
    with torch.no_grad():
        psi_net = mlp.mlp_apply(params, batch["x"], spec.activation).double().cpu().numpy()
    psi_l2, psi_max = psi_errors_3d(psi_net, x1, psi_ref_train)

    summary = {
        "config": "3D GPE ground state (beyond-reference): harmonic trap, "
                  f"{args.n ** 3} collocation pts, γ→{gmax:g}, "
                  "spectral-flow distillation + LM polish",
        "ramp": rows,
        "mu_final": mu_final,
        "mu_grid_final": rows[-1]["mu_grid"],
        "mu_ref_final": mus_ref[gmax],
        "abs_err_final": abs(mu_final - mus_ref[gmax]),
        "abs_err_grid_final": abs(rows[-1]["mu_grid"] - mus_ref[gmax]),
        "oracle_grid_err_bound": grid_err,
        "mu_tf_final": float(thomas_fermi_mu_3d_harmonic(gmax)),
        "psi_l2_err": psi_l2,
        "psi_max_err": psi_max,
        "wall_s": round(wall, 1),
        "seconds": seconds,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    # the midplane slice (z ≈ 0) of the complete solution ψ(x, y, z_mid)
    n = args.n
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    np.savez(os.path.join(args.out, "midplane_z0.npz"),
             pts=np.stack([X.ravel(), Y.ravel()], -1),
             u=psi_net.reshape(n, n, n)[:, :, n // 2].ravel())
    summary["plot"] = viz.draw(
        lambda plots: draw_midplane(args.out, plots),
        f"python -m gpe_tpu_torch.experiments.gpe3d_ground_state --plots --out {args.out}")
    print(json.dumps(summary), flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    save_params(os.path.join(args.out, "params.pkl"), params)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
