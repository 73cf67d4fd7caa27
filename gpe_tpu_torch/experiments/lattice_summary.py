"""Oracle pass for BASELINE config #4 (2D optical lattice), port of
`gpe_tpu/experiments/lattice_summary.py`: the float64 Dirichlet ground state
per γ of the JAX bundle's μ table, on the device.

The lattice is non-confining, so the PINN's ψ = 0 box boundary is part of
the Hamiltonian: the oracle is the split-step imaginary-time solver with the
DST-I Dirichlet kinetic propagator (`validate/imaginary_time.py`,
bc="dirichlet"; n 255 interior points, τ 2e-3, Richardson order 2), warm-
started from γ to γ. The JAX bundle's PL-PINN (a Hermite base with a
q-perturbation) converged to the localized single-well branch, recorded here
as `localized_branch` beside the delocalized ground state.

    python -m gpe_tpu_torch.experiments.lattice_summary [--dir runs/gpe2d_lattice]
        [--out runs_torch/gpe2d_lattice] [--n-oracle 255] [--tau 2e-3]
        [--richardson 2] [--cpu]

Reads `<dir>/bundle.pkl` (the JAX package's pickle, `io.load_bundle`).
Writes `<out>/oracle_cache.npz` (ψ per γ on the interior grid, μ_ref, xi,
dx, V) and merges its sections into `<out>/summary.json` (other sections
kept); the summary adds `seconds` per γ and the device. The run is on the
CUDA card unless `--cpu` is given; it never writes under `runs/`.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def lattice_potential_grid(spec: dict, n: int):
    """V on the n×n interior grid of the spec's box, and the grid (xi, dx).

    V is the spec's potential evaluated on float32 points in float32 and
    widened to float64, as the JAX driver's is (its jnp potential runs in
    JAX's default float32; the committed oracle_cache.npz holds that V).
    The two packages' float32 sin differ by an ulp here and there."""
    import numpy as np
    import torch

    from gpe_tpu_torch.physics import potentials

    lb, ub = float(spec["lb"]), float(spec["ub"])
    dx = (ub - lb) / (n + 1)
    xi = lb + dx * np.arange(1, n + 1)
    X, Y = np.meshgrid(xi, xi, indexing="ij")
    vfn = potentials.get_potential(spec["potential"], **dict(spec["potential_kwargs"]))
    pts = torch.as_tensor(np.stack([X.ravel(), Y.ravel()], axis=-1), dtype=torch.float32)
    V = vfn(pts).double().numpy().reshape(n, n)
    return V, xi, dx


def merge_section(path: str, sections: dict) -> dict:
    """Replace `sections`' keys in the JSON summary at `path` (created if
    absent), keeping every other section; returns the merged summary."""
    summary = {}
    if os.path.exists(path):
        with open(path) as f:
            summary = json.load(f)
    summary.update(sections)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/gpe2d_lattice",
                    help="read: the JAX bundle.pkl")
    ap.add_argument("--out", default="runs_torch/gpe2d_lattice",
                    help="write: oracle_cache.npz, summary.json")
    ap.add_argument("--n-oracle", type=int, default=255,
                    help="interior oracle grid points per axis")
    ap.add_argument("--tau", type=float, default=2e-3)
    ap.add_argument("--richardson", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gpe_tpu_torch.device import resolve_device
    from gpe_tpu_torch.io import load_bundle
    from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe

    dev = resolve_device("cpu" if args.cpu else None)
    bundle = load_bundle(os.path.join(args.dir, "bundle.pkl"))
    spec = bundle["spec"]
    mus = dict(bundle["mu_table"][0])          # mode 0 PL-PINN: {γ: μ}
    kinetic, p = float(spec["kinetic"]), float(spec["p"])
    n = args.n_oracle
    V, xi, dx = lattice_potential_grid(spec, n)

    rows, psis, seconds, psi = [], {}, {}, None
    for g in sorted(mus):
        t0 = time.perf_counter()
        mu_ref, psi = imaginary_time_gpe(
            V, dx, float(g), kinetic=kinetic, p=p, tau=args.tau,
            richardson=args.richardson, bc="dirichlet", psi0=psi, device=dev)
        seconds[str(float(g))] = time.perf_counter() - t0
        psis[float(g)] = psi.cpu().numpy()
        rows.append({"gamma": float(g), "mu_localized_plpinn": float(mus[g]),
                     "mu_ref_ground": float(mu_ref),
                     "branch_gap": float(mus[g] - mu_ref)})
        print(json.dumps(rows[-1]), flush=True)

    gs = sorted(psis)
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "oracle_cache.npz"),
             gammas=np.asarray(gs),
             psis=np.stack([psis[g] for g in gs]),
             mu_refs=np.asarray([next(r["mu_ref_ground"] for r in rows
                                      if r["gamma"] == g) for g in gs]),
             xi=xi, dx=dx, V=V)

    merge_section(os.path.join(args.out, "summary.json"), {
        "experiment": "gpe2d_lattice",
        "oracle": f"imaginary_time dirichlet DST-I n={n} tau={args.tau} "
                  f"richardson={args.richardson}",
        "localized_branch": {
            "note": "committed PL-PINN run (hermite base + q-perturbation) "
                    "converges to the localized single-well branch — a "
                    "symmetry-broken metastable state, NOT the delocalized "
                    "ground state; μ gap vs the ground state below",
            "rows": rows,
            "seconds": seconds,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        },
    })
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
