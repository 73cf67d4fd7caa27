"""Rotating-frame TDGPE experiment — vortex nucleation and Kohn splitting,
port of `gpe_tpu/experiments/rotating_dynamics.py` on
`dynamics/rotating_step.py`:

1. **Spin-up nucleation**: from the Ω = 0 interacting ground state (γ = 50)
   switch the frame rotation on at Ω = 0.9 and follow the renormalised
   flow (imaginary time) from a deterministic symmetry-breaking seed: μ(τ)
   falls, L_z(τ) climbs from 0 as vortices nucleate at the edge and move
   in; the final μ is set beside the n = 128 rows of the committed grid
   oracle table (`runs/gpe2d_vortex/config_oracle_table.json`, read only).
2. **Stationarity**: real-time evolution of the final state over two trap
   periods: L_z and the centre freeze, μ holds to the O(τ) fixed-point
   bias, norm and rotating-frame energy are conserved.
3. **Rotating-frame Kohn splitting**: the vortex state displaced by d obeys
   ζ(t) = ⟨x⟩ + i⟨y⟩ = d·e^{−iΩt}·cos t exactly; reported, the largest
   deviation from that zero-parameter prediction and the two frequencies
   of ζ fitted (`fit_kohn_pair`) against 1 ± Ω.

Everything runs in float64 (complex128) on the device: the CUDA card unless
`--cpu` (the JAX driver ran on the CPU, its TPU having no complex type).

    python -m gpe_tpu_torch.experiments.rotating_dynamics [--n 128] [--cpu]
    python -m gpe_tpu_torch.experiments.rotating_dynamics --plots [--out DIR]
    CPU smoke: ... --cpu --n 48 --spinup-steps 600 --record-every 200 \
               --rt-steps 200 --kohn-steps 400

Writes `<out>/summary.json` (the JAX run's keys, `backend` the device,
`seconds` of each stage and `plot`); `--out` defaults to
`runs_torch/rotating_dynamics`. The nucleation path, the final |ψ|² and the
Kohn trace go to `<out>/rotating_dynamics.npz`, from which
`rotating_dynamics.png` is drawn where matplotlib is installed (`plot`
lists it, or names the `--plots` command that draws it on another host).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

from gpe_tpu_torch import viz

OUT = "runs_torch/rotating_dynamics"
REPO = Path(__file__).resolve().parents[2]
ORACLE_TABLE = REPO / "runs" / "gpe2d_vortex" / "config_oracle_table.json"


def fit_kohn_pair(t, z, omega, span=0.3, rounds=6):
    """Least-squares fit ζ(t) ≈ c + a·e^{−iω₊t} + b·e^{+iω₋t} (the exact
    rotating-frame Kohn form ζ = d·e^{−iΩt}cos t has a = b = d/2, c = 0):
    linear in (c, a, b), so golden-section refinement of ω₊ then ω₋ on the
    least-squares residual, alternating, the span halved each round.
    Returns (ω₊, ω₋, |a|, |b|, rms)."""
    t = np.asarray(t, np.float64)
    z = np.asarray(z, np.complex128)

    def resid(wp, wm):
        M = np.stack([np.ones_like(t), np.exp(-1j * wp * t), np.exp(1j * wm * t)], 1)
        coef, *_ = np.linalg.lstsq(M, z, rcond=None)
        r = z - M @ coef
        return float(np.real(np.conj(r) @ r)), coef

    def golden(f, a, b):
        gr = (np.sqrt(5.0) - 1.0) / 2.0
        c, d = b - gr * (b - a), a + gr * (b - a)
        fc, fd = f(c), f(d)
        for _ in range(60):
            if fc < fd:
                b, d, fd = d, c, fc
                c = b - gr * (b - a)
                fc = f(c)
            else:
                a, c, fc = c, d, fd
                d = a + gr * (b - a)
                fd = f(d)
        return 0.5 * (a + b)

    wp, wm = 1.0 + omega, 1.0 - omega
    for _ in range(rounds):
        wp = golden(lambda w: resid(w, wm)[0], wp - span, wp + span)
        wm = golden(lambda w: resid(wp, w)[0], wm - span, wm + span)
        span *= 0.5
    rss, coef = resid(wp, wm)
    return wp, wm, abs(coef[1]), abs(coef[2]), float(np.sqrt(rss / t.size))


def draw_rotating_dynamics(out_dir: str, plots) -> list:
    """rotating_dynamics.png from `<out_dir>/rotating_dynamics.npz`: L_z
    and the vortex count along the spin-up, the final |ψ|², and ⟨x⟩(t) of
    the Kohn stage beside its prediction."""
    d = np.load(viz.saved(os.path.join(out_dir, "rotating_dynamics.npz")))
    plt = plots.plt
    lb, omega = float(d["lb"]), float(d["omega"])
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
    axes[0].plot(d["tau_t"], d["lz"], label="$L_z$")
    ax2 = axes[0].twinx()
    ax2.plot(d["tau_t"], d["n_vortices"], "C1.-", label="vortices")
    axes[0].set_xlabel(r"imaginary time $\tau$")
    axes[0].set_ylabel(r"$\langle L_z\rangle$")
    ax2.set_ylabel("vortex count")
    axes[0].set_title(f"spin-up Ω=0→{omega}")
    axes[1].imshow(d["density"].T, origin="lower", extent=[lb, -lb, lb, -lb])
    axes[1].set_title(f"|ψ|² final ({int(d['n_vortices'][-1])} vortices)")
    axes[2].plot(d["t"], d["cx"], label=r"$\langle x\rangle$")
    axes[2].plot(d["t"], d["x_pred"], "k--", lw=0.8, label="prediction")
    axes[2].set_xlabel("t")
    axes[2].set_title(r"Kohn splitting $\omega_\pm = 1\pm\Omega$")
    axes[2].legend()
    path = os.path.join(out_dir, "rotating_dynamics.png")
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return [path]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--half", type=float, default=8.0)
    ap.add_argument("--gamma", type=float, default=50.0)
    ap.add_argument("--omega", type=float, default=0.9)
    ap.add_argument("--tau", type=float, default=2e-3)
    ap.add_argument("--spinup-steps", type=int, default=30000)
    ap.add_argument("--record-every", type=int, default=500)
    ap.add_argument("--rt-dt", type=float, default=1e-3)
    ap.add_argument("--rt-steps", type=int, default=12566,
                    help="default 2 trap periods at dt=1e-3")
    ap.add_argument("--kohn-steps", type=int, default=25133,
                    help="Kohn stage length (default 4 trap periods: the splitting "
                         "needs ≥2π/(ω₊−ω₋) of signal)")
    ap.add_argument("--displace", type=float, default=0.5)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--plots", action="store_true",
                    help="draw the figure from <out>/rotating_dynamics.npz; run nothing")
    args = ap.parse_args(argv)
    if args.plots:
        viz.draw_saved(lambda plots: draw_rotating_dynamics(args.out, plots))
        return 0

    import torch

    from gpe_tpu_torch.device import resolve_device
    from gpe_tpu_torch.dynamics import evolve_rotating, rotating_ground_state
    from gpe_tpu_torch.dynamics.split_step import axis_coords
    from gpe_tpu_torch.validate.rotating import vortex_count

    dev = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    seconds = {}
    n, half = args.n, args.half
    lb = -half
    dx = 2.0 * half / (n - 1)
    x0, x1 = axis_coords((n, n), dx, lb, "periodic")
    X, Y = np.meshgrid(x0, x1, indexing="ij")
    V = torch.as_tensor(0.5 * (X ** 2 + Y ** 2), dtype=torch.float64, device=dev)
    rot = dict(lb=lb, device=dev)

    # 1) Ω = 0 ground state (zero circulation)
    mu0, psi0, lz0 = rotating_ground_state(V, dx, args.gamma, 0.0, tau=args.tau,
                                           steps=args.spinup_steps, tol=1e-13,
                                           seed_vortex=False, **rot)
    seconds["omega0_ground"] = time.time() - t0
    print(json.dumps({"stage": "omega0_ground", "mu": mu0, "lz": lz0,
                      "wall_s": round(time.time() - t0, 1)}), flush=True)

    # 2) spin-up: Ω on, the deterministic seed (a vortex-like phase tilt and
    # numpy default_rng(0) noise, as the grid oracle), the nucleation path
    t1 = time.time()
    rng = np.random.default_rng(0)
    Xt = torch.as_tensor(X, device=dev)
    Yt = torch.as_tensor(Y, device=dev)
    psi = psi0 * torch.complex(Xt - 0.3, Yt + 0.2)
    noise = rng.standard_normal(tuple(psi.shape)) + 1j * rng.standard_normal(tuple(psi.shape))
    psi = psi + 0.01 * torch.as_tensor(noise, device=dev) * psi.abs().max()
    psi = psi / torch.sqrt(torch.sum(psi.abs() ** 2) * dx * dx)
    path = {"tau_t": [], "mu": [], "lz": [], "n_vortices": []}
    chunks, rem = divmod(args.spinup_steps, args.record_every)
    for k in list(range(chunks)) + ([None] if rem else []):
        steps = args.record_every if k is not None else rem
        psi, obs = evolve_rotating(psi, V, dx, args.tau, steps, args.gamma, args.omega,
                                   imaginary=True, record_every=steps, **rot)
        path["tau_t"].append(((k + 1) * args.record_every if k is not None
                              else args.spinup_steps) * args.tau)
        path["mu"].append(float(obs["mu"][-1]))
        path["lz"].append(float(obs["lz"][-1]))
        path["n_vortices"].append(vortex_count(psi))
    mu_f, lz_f, nv_f = path["mu"][-1], path["lz"][-1], path["n_vortices"][-1]
    seconds["spinup"] = time.time() - t1
    print(json.dumps({"stage": "spinup", "mu": mu_f, "lz": lz_f, "n_vortices": nv_f,
                      "wall_s": round(time.time() - t0, 1)}), flush=True)

    # the committed grid oracle's n rows at the same (trap, γ, Ω, box)
    oracle_rows = None
    if (ORACLE_TABLE.exists() and args.gamma == 50.0 and args.omega == 0.9
            and args.half == 8.0):
        table = json.loads(ORACLE_TABLE.read_text())
        oracle_rows = {name: [r for r in cfg["rows"] if r["n"] == args.n]
                       for name, cfg in table.items()}

    # 3) stationarity: real-time evolution of the final state
    t1 = time.time()
    _, obs = evolve_rotating(psi, V, dx, args.rt_dt, args.rt_steps, args.gamma,
                             args.omega, record_every=200, **rot)
    e = obs["energy"]
    stationarity = {
        "mu_drift_max": float(np.max(np.abs(obs["mu"] - mu_f))),
        "lz_drift_max": float(np.max(np.abs(obs["lz"] - lz_f))),
        "com_max": float(np.max(np.abs(obs["center"]))),
        "norm_drift": float(np.max(np.abs(obs["norm"] - 1.0))),
        "energy_drift_rel": float(np.max(np.abs(e - e[0])) / max(abs(e[0]), 1e-30)),
    }
    seconds["stationarity"] = time.time() - t1
    print(json.dumps({"stage": "stationarity", **stationarity,
                      "wall_s": round(time.time() - t0, 1)}), flush=True)

    # 4) rotating Kohn splitting: a rigid displacement by whole grid steps
    t1 = time.time()
    shift = int(round(args.displace / dx))
    d_eff = shift * dx
    _, obs = evolve_rotating(torch.roll(psi, shift, dims=0), V, dx, args.rt_dt,
                             args.kohn_steps, args.gamma, args.omega, record_every=20,
                             **rot)
    t = obs["t"]
    cx, cy = obs["center"][:, 0], obs["center"][:, 1]
    x_pred = d_eff * np.cos(t) * np.cos(args.omega * t)
    y_pred = -d_eff * np.cos(t) * np.sin(args.omega * t)
    wp, wm, ap_, am_, fit_rms = fit_kohn_pair(t, cx + 1j * cy, args.omega)
    kohn = {
        "displacement": d_eff,
        "pred_max_dev_x": float(np.max(np.abs(cx - x_pred))),
        "pred_max_dev_y": float(np.max(np.abs(cy - y_pred))),
        "omega_plus_fit": wp, "omega_plus_exact": 1 + args.omega,
        "omega_plus_abs_err": abs(wp - (1 + args.omega)),
        "omega_minus_fit": wm, "omega_minus_exact": 1 - args.omega,
        "omega_minus_abs_err": abs(wm - (1 - args.omega)),
        "weight_ratio": float(ap_ / am_), "weight_ratio_exact": 1.0,
        "fit_rms": fit_rms,
    }
    seconds["kohn_splitting"] = time.time() - t1
    print(json.dumps({"stage": "kohn_splitting", **kohn,
                      "wall_s": round(time.time() - t0, 1)}), flush=True)

    summary = {
        "config": (f"rotating-frame TDGPE: n={n}² grid, γ={args.gamma}, "
                   f"Ω 0→{args.omega} spin-up quench ({args.spinup_steps} imaginary "
                   f"steps τ={args.tau}) + {args.rt_steps} real-time steps "
                   f"dt={args.rt_dt}"),
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dtype": "complex128",
        "omega0_ground": {"mu": mu0, "lz": lz0},
        "spinup_final": {"mu": mu_f, "lz": lz_f, "n_vortices": nv_f},
        "nucleation_path": path,
        "flagship_oracle_n128_rows": oracle_rows,
        "stationarity": stationarity,
        "kohn_splitting": kohn,
        "seconds": seconds,
        "wall_s": round(time.time() - t0, 1),
    }
    np.savez(os.path.join(args.out, "rotating_dynamics.npz"), tau_t=path["tau_t"],
             lz=path["lz"], n_vortices=path["n_vortices"],
             density=(psi.abs() ** 2).cpu().numpy(), lb=lb, omega=args.omega, t=t, cx=cx,
             x_pred=x_pred)
    summary["plot"] = viz.draw(
        lambda plots: draw_rotating_dynamics(args.out, plots),
        f"python -m gpe_tpu_torch.experiments.rotating_dynamics --plots --out {args.out}")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"summary": "written", "wall_s": summary["wall_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
