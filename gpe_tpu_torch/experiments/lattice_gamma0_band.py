"""The lattice's γ = 0 rung by the band-subspace route, port of
`gpe_tpu/experiments/lattice_gamma0_band.py`.

At γ = 0 the 3×3-well optical lattice is linear and its lowest band is
near-degenerate, so the imaginary-time oracle (and a distillation target
from it) relaxes slowly within the band, and the PDE residual is flat
against in-band contamination. Both sides of the fix:

- stage `grid` (host, float64, scipy as in JAX): sparse shift-invert eigsh
  on the Dirichlet FD Hamiltonian gives the lowest band φ₀..φ_{k−1} at two
  grid sizes, Richardson-extrapolated to E*;
- stage `net` (the device): a Sobolev (value + ∇) distillation of a width-
  192 net from the exact φ₀ (`pretrain_sobolev`, ∇φ₀ by finite differences
  on the fine grid), then an LM polish (`make_lm_solver`) of the
  normalised PDE residual with orthogonality rows ⟨φ_k, ψ⟩ (k ≥ 1)
  appended, so the polish cannot wander within the band. Width 192 > 128:
  no fused kernel runs, as in JAX.

    python -m gpe_tpu_torch.experiments.lattice_gamma0_band [--stage grid|net|all]
        [--dir runs/gpe2d_lattice] [--out runs_torch/gpe2d_lattice] [--k 9]
        [--n-colloc 128] [--width 192] [--pretrain-epochs 20000]
        [--polish-steps 400] [--orth-weight 1.0] [--cpu]

`grid` reads `<dir>/bundle.pkl` and writes `<out>/band_cache.npz` and
`<out>/band_table.json`. `net` reads the band cache (from `<out>` when
`grid` ran in the same call, else from `<dir>`: the committed JAX cache by
default) and `<dir>/oracle_cache.npz`, and merges the "gamma0_band" section
into `<out>/summary.json` (other sections kept; it adds the stages'
seconds and the device). The net stage runs on the CUDA card unless
`--cpu` is given; nothing is written under `runs/`.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def _spec_dict(read_dir: str) -> dict:
    from gpe_tpu_torch.io import load_bundle
    return load_bundle(os.path.join(read_dir, "bundle.pkl"))["spec"]


def stage_grid(k: int, ns=(191, 255), read_dir: str = "runs/gpe2d_lattice",
               out_dir: str = "runs_torch/gpe2d_lattice") -> dict:
    """The lowest k states of the FD Dirichlet Hamiltonian at each n of
    `ns` (coarse, fine) and their Richardson extrapolation; returns the band
    table it writes."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh

    from gpe_tpu_torch.experiments.lattice_summary import lattice_potential_grid

    spec = _spec_dict(read_dir)
    kin = float(spec["kinetic"])
    out = {}
    for n in ns:
        V, xi, dx = lattice_potential_grid(spec, n)
        t0 = time.time()
        main_d = np.full(n, 2.0) / dx**2
        off = np.full(n - 1, -1.0) / dx**2
        D = sp.diags([off, main_d, off], (-1, 0, 1))
        H = kin * (sp.kron(D, sp.eye(n)) + sp.kron(sp.eye(n), D)) \
            + sp.diags(V.ravel())
        # shift-invert at σ=0: H is positive definite, and the band sits at
        # the bottom of the spectrum — 'LM' of H⁻¹ is exactly the band
        es, vecs = eigsh(H.tocsc(), k=k, sigma=0.0, which="LM")
        idx = np.argsort(es)
        es, vecs = es[idx], vecs[:, idx]
        print(f"n={n}: band E = {[round(float(e), 6) for e in es]} "
              f"({time.time() - t0:.0f}s)", flush=True)
        out[n] = (es, vecs, xi, dx)

    n_c, n_f = ns
    es_c, es_f = out[n_c][0], out[n_f][0]
    h_c, h_f = 1.0 / (n_c + 1), 1.0 / (n_f + 1)
    # 2nd-order FD: E(h) = E* + a·h², two grids → E*
    e_star = (es_f * h_c**2 - es_c * h_f**2) / (h_c**2 - h_f**2)

    es, vecs, xi, dx = out[n_f]
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "band_cache.npz"), energies=es, e_star=e_star,
             xi=xi, dx=dx, band=vecs.reshape(n_f, n_f, k))
    table = {
        "band_E_coarse": [float(e) for e in es_c],
        "band_E_fine": [float(e) for e in es_f],
        "band_E_star": [float(e) for e in e_star],
        "band_spread_E0_to_Ek": float(e_star[-1] - e_star[0]),
        "gap_E1_minus_E0": float(e_star[1] - e_star[0]),
    }
    with open(os.path.join(out_dir, "band_table.json"), "w") as f:
        json.dump(table, f, indent=2)
    print(json.dumps(table), flush=True)
    return table


def stage_net(n_colloc: int, width: int, pretrain_epochs: int, polish_steps: int,
              orth_weight: float, read_dir: str = "runs/gpe2d_lattice",
              cache_dir: str = "runs/gpe2d_lattice",
              out_dir: str = "runs_torch/gpe2d_lattice", device=None) -> dict:
    """Distil the net from the exact φ₀ and LM-polish it with the band's
    orthogonality rows; returns the section it merges into the summary."""
    import numpy as np
    import torch
    from scipy.interpolate import RegularGridInterpolator

    from gpe_tpu_torch.device import pin_full_f32, resolve_device
    from gpe_tpu_torch.experiments.lattice_summary import merge_section
    from gpe_tpu_torch.models import mlp
    from gpe_tpu_torch.ops.rayleigh import hamiltonian_apply
    from gpe_tpu_torch.train.gauss_newton import make_lm_solver
    from gpe_tpu_torch.train.pretrain import pretrain_sobolev
    from gpe_tpu_torch.train.problem import GPESpec, make_batch

    pin_full_f32()
    dev = resolve_device(device)
    sd = _spec_dict(read_dir)
    cache = np.load(os.path.join(cache_dir, "band_cache.npz"))
    xi, dx = np.asarray(cache["xi"]), float(cache["dx"])
    band = np.asarray(cache["band"])            # (n, n, k)
    k = band.shape[-1]
    e_star = np.asarray(cache["e_star"])
    lb, ub = float(xi[0] - dx), float(xi[-1] + dx)

    spec = GPESpec(dim=2, lb=lb, ub=ub, n_points=n_colloc,
                   layers=(2, width, width, width, 1),
                   activation="shifted_tanh", potential=sd["potential"],
                   potential_kwargs=tuple(sd["potential_kwargs"]),
                   basis="hermite", kinetic=float(sd["kinetic"]),
                   nonlinearity=sd.get("nonlinearity", "abs_power"),
                   use_perturbation=False)
    batch = make_batch(spec, 0, device=dev)
    xcol = batch["x"].cpu().numpy()
    w = batch["w"].cpu().numpy()
    grid = np.concatenate([[lb], xi, [ub]])

    def to_colloc(f):
        full = np.zeros((grid.size, grid.size))
        full[1:-1, 1:-1] = f
        g = RegularGridInterpolator((grid, grid), full, method="cubic")(xcol)
        return g / np.sqrt(np.sum(g * g) * w[0])

    # φ₀ target (exact linear ground state) + the in-band deflation set
    targets = [to_colloc(band[:, :, j] / dx) for j in range(k)]
    phi0 = targets[0]
    # eigsh's sign is arbitrary; make the target positive-dominant
    if float(np.sum(phi0)) < 0:
        targets = [-t for t in targets]
        phi0 = targets[0]
    phis = torch.as_tensor(np.stack(targets[1:], axis=0), dtype=torch.float32,
                           device=dev)                                  # (k-1, n²)

    params = mlp.init_mlp(spec.layers, generator=torch.Generator().manual_seed(0),
                          device=dev)
    t0 = time.time()
    # H¹ (Sobolev) distillation: a value-only fit leaves the derivatives,
    # where μ is read, loose; ∇φ₀ from 2nd-order FD on the fine eigsh grid
    full0 = np.zeros((grid.size, grid.size))
    full0[1:-1, 1:-1] = band[:, :, 0] / dx
    gx, gy = np.gradient(full0, grid, grid, axis=(0, 1))
    itp = dict(method="cubic")
    gI = RegularGridInterpolator((grid, grid), full0, **itp)(xcol)
    scale0 = float(np.sqrt(np.sum(gI * gI) * w[0]))
    sgn = np.sign(np.sum(gI)) or 1.0
    tjac = np.stack([
        RegularGridInterpolator((grid, grid), gx, **itp)(xcol),
        RegularGridInterpolator((grid, grid), gy, **itp)(xcol)],
        axis=1).astype(np.float32) / (scale0 * sgn)
    params, pre_mse = pretrain_sobolev(params, batch["x"], phi0.astype(np.float32), tjac,
                                       spec.activation, epochs=pretrain_epochs,
                                       lbfgs_steps=800, jac_weight=0.2)
    distill_s = time.time() - t0
    print(f"sobolev distill from exact phi0: mse {pre_mse:.2e} ({distill_s:.0f}s)",
          flush=True)

    act = spec.activation
    w_orth = float(orth_weight)

    def residuals(p, b, g, s):
        n = mlp.mlp_vgl(p, b["x"], act)
        norm = torch.sqrt(torch.sum(n.value ** 2 * b["w"]) + 1e-30)
        u = n.value / norm
        lap = n.lap / norm
        hu = hamiltonian_apply(u, lap, b["V"], g, spec.p, spec.kinetic,
                               spec.nonlinearity)
        mu = torch.sum(u * hu) / (torch.sum(u * u) + 1e-12)
        r = (hu - mu * u) / float(u.shape[0]) ** 0.5
        # orthogonality rows: quadrature projections onto the exact excited
        # band states — in-band drift now costs residual
        proj = w_orth * (phis @ (u * b["w"]))
        return torch.cat([r, proj])

    t1 = time.time()
    lm = make_lm_solver(residuals, params, steps=polish_steps, cg_iters=100)
    params = lm(params, batch, 0.0, 1.0).params
    polish_s = time.time() - t1

    # mesh-free report (analytic derivatives, normalised), on the host
    with torch.no_grad():
        n = mlp.mlp_vgl(params, batch["x"], act)
    val = n.value.double().cpu().numpy()
    norm = float(np.sqrt(np.sum(val ** 2 * w)))
    u = val / norm
    lap = n.lap.double().cpu().numpy() / norm
    V = batch["V"].cpu().numpy()
    hu = -spec.kinetic * lap + V * u
    mu = float(np.sum(u * hu) / np.sum(u * u))
    pde = float(np.mean((hu - mu * u) ** 2))
    projs = [float(np.sum(t * u * w)) for t in targets[1:]]

    # reference values: Richardson-extrapolated eigsh E0* and the committed
    # imaginary-time oracle row
    e0_star = float(e_star[0])
    mu_ref_it = None
    oc = os.path.join(read_dir, "oracle_cache.npz")
    if os.path.exists(oc):
        occ = np.load(oc)
        gs = [float(g) for g in occ["gammas"]]
        if 0.0 in gs:
            mu_ref_it = float(occ["mu_refs"][gs.index(0.0)])

    section = {
        "note": "gamma=0 band route: exact eigsh phi0 distill + "
                "orthogonality-deflated LM polish (VERDICT r3 #4)",
        "mu_net": mu, "E0_star_eigsh": e0_star,
        "abs_err_vs_E0_star": abs(mu - e0_star),
        "mu_ref_imaginary_time": mu_ref_it,
        "abs_err_vs_it_oracle": (abs(mu - mu_ref_it)
                                 if mu_ref_it is not None else None),
        "pde_loss": pde, "distill_mse": float(pre_mse),
        "band_projections_after_polish": projs,
        "band_gap_E1_E0": float(e_star[1] - e_star[0]),
        "polish_steps": polish_steps, "orth_weight": w_orth,
        "wall_s": round(time.time() - t0, 1),
        "seconds": {"distill": distill_s, "polish": polish_s},
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    merge_section(os.path.join(out_dir, "summary.json"), {"gamma0_band": section})
    print(json.dumps(section), flush=True)
    return section


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=("grid", "net", "all"), default="all")
    ap.add_argument("--dir", default="runs/gpe2d_lattice",
                    help="read: bundle.pkl, oracle_cache.npz, band_cache.npz")
    ap.add_argument("--out", default="runs_torch/gpe2d_lattice",
                    help="write: band_cache.npz, band_table.json, summary.json")
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--n-colloc", type=int, default=128)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--pretrain-epochs", type=int, default=20000)
    ap.add_argument("--polish-steps", type=int, default=400)
    ap.add_argument("--orth-weight", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true", help="run the net stage on the CPU")
    args = ap.parse_args(argv)
    if args.stage in ("grid", "all"):
        stage_grid(args.k, read_dir=args.dir, out_dir=args.out)
    if args.stage in ("net", "all"):
        stage_net(args.n_colloc, args.width, args.pretrain_epochs,
                  args.polish_steps, args.orth_weight, read_dir=args.dir,
                  cache_dir=args.out if args.stage == "all" else args.dir,
                  out_dir=args.out, device="cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
