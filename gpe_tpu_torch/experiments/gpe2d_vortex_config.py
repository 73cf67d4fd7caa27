"""Configuration-matched Ω = 0.9 vortex experiment, port of
`gpe_tpu/experiments/gpe2d_vortex_config.py`.

The Ω = 0.9 rotating-frame ground state is multi-stable: the float64 ADI
oracle lands on a 9-vortex configuration at n = 128 and a 7-vortex one at
n = 192, their μ ~3e-3 apart, so "μ error against the oracle" mixes the
choice of configuration with the solver's accuracy. The two stages part
them:

- `oracle` (float64, on the device): each configuration (v9 seeded at
  n = 128, v7 at n = 192) refined on finer grids — the converged ψ
  cubic-regridded and imaginary time continued from it (the warm start
  keeps the basin) — gives a per-grid μ/E/L_z table and caches the finest
  ψ of each configuration.
- `net`: the net distilled from each configuration's finest cached ψ
  (regridded to the collocation grid), the complex residual LM-polished;
  reports |μ_net − μ*_config| within the configuration and the energy
  E[ψ_net], whose ordering is set beside the oracle's.

    python -m gpe_tpu_torch.experiments.gpe2d_vortex_config --stage oracle|net|all
        [--out DIR] [--cpu]

Writes `<out>/config_oracle_cache.npz` and `<out>/config_oracle_table.json`
(stage oracle) and `<out>/config_matched.json` (stage net, from the cache in
`<out>`). `--out` defaults to `runs_torch/gpe2d_vortex`. On the CUDA card
unless `--cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import time

OUT = "runs_torch/gpe2d_vortex"
GAMMA, OMEGA, TRAP, KIN = 50.0, 0.9, 0.5, 0.5
LB, UB = -8.0, 8.0
# configuration name -> (seed grid, refinement grids)
CONFIGS = {"v9": (128, (192, 256)), "v7": (192, (256,))}


def _grid(n):
    import numpy as np
    x1 = np.linspace(LB, UB, n)
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    return x1, TRAP * (X ** 2 + Y ** 2)


def stage_oracle(steps: int, refine_steps: int, tau: float, out: str = OUT,
                 configs=None, device=None) -> dict:
    """Each configuration's seed run and refinements; writes the cache and
    the table into `out` and returns the table."""
    import numpy as np

    from gpe_tpu_torch.device import resolve_device
    from gpe_tpu_torch.validate.rotating import (regrid_psi, rotating_energy,
                                                 rotating_imaginary_time,
                                                 vortex_count)

    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    cache, table = {}, {}
    for name, (n_seed, refines) in (configs or CONFIGS).items():
        x1, V = _grid(n_seed)
        t0 = time.time()
        mu, psi, lz = rotating_imaginary_time(V, x1, GAMMA, OMEGA, kinetic=KIN, tau=tau,
                                              steps=steps, device=dev)
        rows = [{"n": n_seed, "mu": mu,
                 "E": rotating_energy(psi, V, x1, GAMMA, OMEGA, KIN), "lz": lz,
                 "vortices": vortex_count(psi), "wall_s": round(time.time() - t0, 1)}]
        print(f"{name}: seed n={n_seed} μ={mu:.6f} Lz={lz:.4f} nv={rows[0]['vortices']}",
              flush=True)
        x_prev, psi_prev = x1, psi
        for n in refines:
            x1f, Vf = _grid(n)
            t0 = time.time()
            mu, psi_f, lz = rotating_imaginary_time(
                Vf, x1f, GAMMA, OMEGA, kinetic=KIN, tau=tau, steps=refine_steps,
                psi0=regrid_psi(psi_prev, x_prev, x1f), seed_vortex=False, device=dev)
            rows.append({"n": n, "mu": mu,
                         "E": rotating_energy(psi_f, Vf, x1f, GAMMA, OMEGA, KIN),
                         "lz": lz, "vortices": vortex_count(psi_f),
                         "wall_s": round(time.time() - t0, 1)})
            print(f"{name}: refine n={n} μ={mu:.6f} Lz={lz:.4f} "
                  f"nv={rows[-1]['vortices']}", flush=True)
            x_prev, psi_prev = x1f, psi_f
        table[name] = {"rows": rows, "mu_star": rows[-1]["mu"], "E_star": rows[-1]["E"],
                       "mu_grid_spread": abs(rows[-1]["mu"] - rows[-2]["mu"]),
                       "seed_vortices": rows[0]["vortices"],
                       "final_vortices": rows[-1]["vortices"]}
        psi_np = psi_prev.cpu().numpy()
        cache[f"{name}_psi_re"] = np.real(psi_np)
        cache[f"{name}_psi_im"] = np.imag(psi_np)
        cache[f"{name}_x"] = np.asarray(x_prev)
        cache[f"{name}_mu"] = rows[-1]["mu"]
        cache[f"{name}_lz"] = rows[-1]["lz"]
    np.savez(os.path.join(out, "config_oracle_cache.npz"), **cache)
    with open(os.path.join(out, "config_oracle_table.json"), "w") as f:
        json.dump(table, f, indent=2)
    print(json.dumps(table, indent=1), flush=True)
    return table


def stage_net(n_colloc: int, width: int, fit_epochs: int, lbfgs_steps: int,
              polish_steps: int, activation: str = "sin", init_scheme: str = "siren",
              w0: float = 3.0, cg_iters: int = 100, sobolev_n: int = 128,
              out: str = OUT, device=None) -> dict:
    """The net distilled from each cached configuration; writes and returns
    `config_matched.json`'s record."""
    import numpy as np

    from gpe_tpu_torch.device import resolve_device
    from gpe_tpu_torch.rotating import RotatingSpec, train_rotating_vortex
    from gpe_tpu_torch.validate.rotating import regrid_psi

    dev = resolve_device(device)
    with open(os.path.join(out, "config_oracle_table.json")) as f:
        table = json.load(f)
    cache = np.load(os.path.join(out, "config_oracle_cache.npz"))
    results = {}
    for name in table:
        psi = cache[f"{name}_psi_re"] + 1j * cache[f"{name}_psi_im"]
        spec = RotatingSpec(n_points=n_colloc, lb=LB, ub=UB,
                            layers=(2, width, width, width, 2), activation=activation,
                            init_scheme=init_scheme, w0=w0, gamma=GAMMA, omega=OMEGA,
                            trap=TRAP, kinetic=KIN)
        target_psi = regrid_psi(psi, cache[f"{name}_x"], np.linspace(LB, UB, n_colloc),
                                device=dev)
        t0 = time.time()
        res = train_rotating_vortex(
            spec, fit_epochs=fit_epochs, lbfgs_steps=lbfgs_steps,
            polish_steps=polish_steps, polish_cg_iters=cg_iters,
            target=(target_psi, float(cache[f"{name}_mu"]), float(cache[f"{name}_lz"])),
            sobolev=True, sobolev_n=sobolev_n, verbose=True, device=dev)
        mu_star = table[name]["mu_star"]
        results[name] = {
            "config": name, "mu_net": res.mu, "mu_star_oracle": mu_star,
            "within_config_mu_err": abs(res.mu - mu_star),
            "E_net": res.energy, "E_star_oracle": table[name]["E_star"],
            "lz_net": res.lz, "lz_oracle": float(cache[f"{name}_lz"]),
            "n_vortices_target": res.n_vortices, "pde_loss": res.pde_loss,
            "fit_mse": res.fit_mse, "oracle_grid_spread": table[name]["mu_grid_spread"],
            "wall_s": round(time.time() - t0, 1)}
        print(json.dumps(results[name]), flush=True)
    summary = {
        "experiment": "Omega=0.9 configuration-matched vortex rows",
        "gamma": GAMMA, "omega": OMEGA, "per_config": results,
        "oracle_energy_ordering": sorted(table, key=lambda k: results[k]["E_star_oracle"]),
        "net_energy_ordering": sorted(table, key=lambda k: results[k]["E_net"]),
        "oracle_convergence": {k: table[k]["rows"] for k in table},
        "device": str(dev)}
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "config_matched.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({"written": "config_matched.json", "within_config_mu_err": {
        k: results[k]["within_config_mu_err"] for k in results}}), flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=("oracle", "net", "all"), default="all")
    ap.add_argument("--oracle-steps", type=int, default=40000)
    ap.add_argument("--refine-steps", type=int, default=25000)
    ap.add_argument("--tau", type=float, default=2e-3)
    ap.add_argument("--n-colloc", type=int, default=160)
    ap.add_argument("--width", type=int, default=176)
    ap.add_argument("--fit-epochs", type=int, default=15000)
    ap.add_argument("--lbfgs-steps", type=int, default=1200)
    ap.add_argument("--polish-steps", type=int, default=900)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--sobolev-n", type=int, default=128)
    ap.add_argument("--activation", default="sin")
    ap.add_argument("--init-scheme", default="siren")
    ap.add_argument("--w0", type=float, default=3.0)
    ap.add_argument("--configs", type=json.loads, default=None,
                    help='JSON {"name": [seed n, [refinement n, ...]]} in place of '
                         "v9/v7 (cut runs)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.stage in ("oracle", "all"):
        stage_oracle(args.oracle_steps, args.refine_steps, args.tau, args.out,
                     args.configs, device)
    if args.stage in ("net", "all"):
        stage_net(args.n_colloc, args.width, args.fit_epochs, args.lbfgs_steps,
                  args.polish_steps, args.activation, args.init_scheme, args.w0,
                  args.cg_iters, args.sobolev_n, args.out, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
