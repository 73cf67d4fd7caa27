"""TDGPE dynamics flagship — quench response of the interacting 2D (or 3D)
gas, port of `gpe_tpu/experiments/gpe_dynamics.py` on
`dynamics/split_step.py` (torch.fft):

1. **Kohn dipole mode**: the γ ground state of the trap displaced by d,
   released into the centred trap; the centre of mass oscillates at the
   bare trap frequency ω = 1, undamped, at any γ (Kohn's theorem).
2. **Breathing mode**: the interaction quenched γ → λγ; in 2D the hidden
   SO(2,1) symmetry (Pitaevskii–Rosch) makes the monopole frequency exactly
   2ω at any γ and amplitude; in 3D it lies between 2 (γ = 0) and √5 (the
   Thomas–Fermi limit).

Also: the norm drift, the post-quench energy drift and the propagator's
throughput (grid-point·steps/s: on the card the difference of a steps and a
steps/4 call, each ending in the read of its observables, so the host's
set-up cancels). The JAX driver routed its TPU to the GEMM engine, which
lacks complex types; the card has them, so the port runs the FFT engine
everywhere (`evolve`, `ground_state`).

The kinetic coefficient c of −c·Δ is `KINETIC` (0.5) throughout: the
ground states, the evolutions, the 1D sweep's dt and the f32
parametric-resonance guard, which takes it as an argument
(`resonance_guard`; the JAX driver writes 0.5 into the guard's formula).

    python -m gpe_tpu_torch.experiments.gpe_dynamics [--dims 2|3] [--f32] [--cpu]
    python -m gpe_tpu_torch.experiments.gpe_dynamics --plots [--out DIR]
    CPU smoke: ... --cpu --n 64 --steps 800 --gamma 10 --gs-steps 2000

Writes `<out>/summary[_3d].json` (`summary_f32[_3d].json` with --f32, which
embeds the f64 summary of the same dims in `<out>` when there is one) with
the JAX run's keys, `backend` the device, and `plot`; `--breathing-1d-sweep`
writes `<out>/breathing_1d.json`. `--out` defaults to
`runs_torch/gpe_dynamics`. The two modes' traces (⟨x⟩(t) and ⟨r²⟩(t) with
their fitted ω) go to `<out>/quench_modes.npz`, from which
`quench_modes.png` is drawn where matplotlib is installed (`plot` lists
it, or names the `--plots` command that draws it on another host); as in
the JAX driver, each run of an `--out` replaces them.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

from gpe_tpu_torch import viz

OUT = "runs_torch/gpe_dynamics"
KINETIC = 0.5  # c of −c·Δ


def fit_frequency(t, y):
    """Least-squares fit y ≈ C + A·cos(ωt) + B·sin(ωt): the FFT peak seeds ω,
    golden-section refinement on the linear fit's residual. Returns (ω,
    amplitude, rms)."""
    t = np.asarray(t, np.float64)
    y = np.asarray(y, np.float64)
    yc = y - y.mean()
    dt = t[1] - t[0]
    freqs = np.fft.rfftfreq(t.size, d=dt) * 2.0 * np.pi
    spec = np.abs(np.fft.rfft(yc))
    k = int(np.argmax(spec[1:]) + 1)

    def resid(w):
        M = np.stack([np.ones_like(t), np.cos(w * t), np.sin(w * t)], 1)
        coef, *_ = np.linalg.lstsq(M, y, rcond=None)
        r = y - M @ coef
        return float(r @ r), coef

    a, b = freqs[max(k - 2, 1)], freqs[min(k + 2, freqs.size - 1)]
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = resid(c)[0], resid(d)[0]
    for _ in range(80):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = resid(c)[0]
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = resid(d)[0]
    w = 0.5 * (a + b)
    rss, coef = resid(w)
    return float(w), float(np.hypot(coef[1], coef[2])), float(np.sqrt(rss / t.size))


def resonance_guard(t_end: float, steps: int, dx: float, dim: int, kinetic: float):
    """(steps, record or None): the f32 parametric-resonance guard. A mode
    whose kinetic phase per step dt·c·k² reaches π is pumped by the
    nonlinear term (the split step is unitary, so the norm does not show
    it); in f32 the corner modes start at ~1e-7 and explode within a few
    periods. Steps are raised, minimally, until dt·c·k²_corner ≤ 0.9π,
    k²_corner = dim·(π/dx)², with c the run's kinetic coefficient."""
    kmax2_corner = dim * (math.pi / dx) ** 2
    dt_safe = 0.9 * math.pi / (kinetic * kmax2_corner)
    if t_end / steps <= dt_safe:
        return steps, None
    new = int(math.ceil(t_end / dt_safe))
    return new, {"requested_steps": steps, "steps": new, "kinetic": kinetic,
                 "dt_threshold_pi_over_ck2": math.pi / (kinetic * kmax2_corner)}


def breathing_sweep_1d(out_dir, gammas=(0.0, 1.0, 5.0, 20.0, 100.0, 500.0), n=512,
                       half=16.0, quench=1.05, periods=6.0, gs_steps=30000,
                       kinetic=KINETIC, dtype=None, device=None):
    """1D monopole frequency against γ: from ω = 2 at γ = 0 to √3 in the
    Thomas–Fermi limit (Menotti & Stringari, PRA 66 043610), in the linear
    response of a small quench γ → 1.05γ. dt sits below the split step's
    parametric-resonance threshold π/(c·k_max²) (0.8 of it)."""
    import torch

    from gpe_tpu_torch.dynamics import evolve, ground_state

    dtype = dtype or torch.float64
    x = np.linspace(-half, half, n, endpoint=False)
    dx = float(x[1] - x[0])
    V = torch.as_tensor(0.5 * x * x, dtype=dtype, device=device)
    t_end = periods * 2.0 * np.pi
    dt = 0.8 * np.pi / (kinetic * (np.pi / dx) ** 2)
    steps = int(np.ceil(t_end / dt))
    rec = max(1, steps // 600)
    rows = []
    for g in gammas:
        _, psi = ground_state(V, dx, float(g), kinetic, tau=2e-3, steps=gs_steps,
                              tol=1e-12, device=device)
        _, obs = evolve(psi, V, dx, dt, steps, quench * float(g), kinetic, bc="periodic",
                        lb=float(x[0]), record_every=rec, device=device)
        w, amp, rms = fit_frequency(obs["t"], obs["width_sq"][:, 0])
        rows.append({"gamma": float(g), "omega_fit": w, "amplitude": amp,
                     "fit_rms": rms})
        print(json.dumps(rows[-1]), flush=True)
    table = {"config": f"1D breathing-mode crossover, {n} pts, quench ×{quench:g}, "
                       f"{periods:g} periods",
             "omega_gamma0_exact": 2.0, "omega_tf_exact": float(np.sqrt(3.0)),
             "rows": rows}
    with open(os.path.join(out_dir, "breathing_1d.json"), "w") as f:
        json.dump(table, f, indent=1)
    return table


def timed_throughput(evolve_call, n_pts: int, steps: int) -> float:
    """Grid-point·steps/s of `evolve_call(k)` (which returns its observables
    read to the host): the time of a `steps` call less that of a steps/4
    call, each run once before it is timed, over the step difference. A
    difference that is not positive raises (no clamp)."""
    k1, k2 = max(steps // 4, 1), steps
    evolve_call(k1), evolve_call(k2)
    t0 = time.perf_counter()
    evolve_call(k1)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    evolve_call(k2)
    t2 = time.perf_counter() - t0
    if not t2 > t1:
        raise ValueError(f"throughput does not resolve: {k2} steps {t2} s, "
                         f"{k1} steps {t1} s")
    return n_pts * (k2 - k1) / (t2 - t1)


def draw_quench_modes(out_dir: str, plots) -> list:
    """quench_modes.png from `<out_dir>/quench_modes.npz`: the dipole's
    ⟨x⟩(t) beside d·cos t, and the breathing mode's ⟨r²⟩(t), each titled
    with its fitted ω."""
    d = np.load(viz.saved(os.path.join(out_dir, "quench_modes.npz")))
    plt = plots.plt
    plots.use_publication_style()
    fig, axes = plt.subplots(1, 2, figsize=(10, 3.4))
    axes[0].plot(d["t_k"], d["cx"], lw=1.2, label=r"$\langle x\rangle(t)$")
    axes[0].plot(d["t_k"], d["d"] * np.cos(d["t_k"]), "--", lw=1.0,
                 label=r"$d\cos(\omega t)$ (Kohn)")
    axes[0].set_xlabel("t")
    axes[0].set_title(f"dipole: $\\omega$={float(d['w_dip']):.6f} (exact 1)")
    axes[0].legend()
    axes[1].plot(d["t_b"], d["w2"], lw=1.2, label=r"$\langle r^2\rangle(t)$")
    axes[1].set_xlabel("t")
    axes[1].set_title(f"breathing: $\\omega$={float(d['w_br']):.6f} (exact 2)")
    axes[1].legend()
    fig.tight_layout()
    path = os.path.join(out_dir, "quench_modes.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return [path]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256, help="grid side (n^dims)")
    ap.add_argument("--half", type=float, default=12.0)
    ap.add_argument("--dims", type=int, default=2, choices=(2, 3),
                    help="3: 3D Kohn dipole + monopole quench (reported between its "
                         "exact limits 2 (γ=0) and √5 (TF))")
    ap.add_argument("--gamma", type=float, default=100.0)
    ap.add_argument("--displace", type=float, default=0.5)
    ap.add_argument("--quench", type=float, default=1.3,
                    help="breathing quench factor λ: γ → λγ at t=0")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--periods", type=float, default=4.0,
                    help="evolution length in trap periods 2π/ω")
    ap.add_argument("--gs-steps", type=int, default=30000)
    ap.add_argument("--f32", action="store_true",
                    help="complex64 path (conservation floors at ~1e-4, not 1e-12)")
    ap.add_argument("--breathing-1d-sweep", action="store_true",
                    help="run ONLY the 1D monopole crossover sweep (ω: 2 → √3 with γ)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--out-name", default=None,
                    help="summary filename (default summary[_3d].json, "
                         "summary_f32[_3d].json with --f32)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--plots", action="store_true",
                    help="draw the figure from <out>/quench_modes.npz; run nothing")
    args = ap.parse_args(argv)
    if args.plots:
        viz.draw_saved(lambda plots: draw_quench_modes(args.out, plots))
        return 0

    import torch

    from gpe_tpu_torch.device import resolve_device
    from gpe_tpu_torch.dynamics import evolve, ground_state

    dev = resolve_device("cpu" if args.cpu else None)
    rd = torch.float32 if args.f32 else torch.float64
    os.makedirs(args.out, exist_ok=True)
    if args.breathing_1d_sweep:
        breathing_sweep_1d(args.out, dtype=rd, device=dev)
        return 0
    n, half, gam, dim, c = args.n, args.half, args.gamma, args.dims, KINETIC
    n_pts = n ** dim
    x1 = np.linspace(-half, half, n, endpoint=False)
    dx = float(x1[1] - x1[0])
    grids = np.meshgrid(*([x1] * dim), indexing="ij")
    X = grids[0]
    r2_rest = sum(g ** 2 for g in grids[1:])
    V = torch.as_tensor(0.5 * (X ** 2 + r2_rest), dtype=rd, device=dev)
    t_end = args.periods * 2.0 * np.pi
    steps, guard = args.steps, None
    if args.f32:
        steps, guard = resonance_guard(t_end, args.steps, dx, dim, c)
        if guard is not None:
            print(f"f32 resonance guard: steps {args.steps} -> {steps}", flush=True)
    dt = t_end / steps
    rec = max(1, steps // 400)
    run = dict(bc="periodic", lb=float(x1[0]), device=dev)

    # Kohn dipole: the γ ground state of the displaced trap, released
    t0 = time.time()
    d = args.displace
    V_d = torch.as_tensor(0.5 * ((X - d) ** 2 + r2_rest), dtype=rd, device=dev)
    _, psi_d = ground_state(V_d, dx, gam, c, tau=2e-3, steps=args.gs_steps, tol=1e-12,
                            device=dev)
    wall_gs = time.time() - t0
    t0 = time.time()
    _, obs_k = evolve(psi_d, V, dx, dt, steps, gam, c, record_every=rec, **run)
    wall_k = time.time() - t0
    cx = obs_k["center"][:, 0]
    w_dip, amp_dip, rms_dip = fit_frequency(obs_k["t"], cx)

    # breathing: the interaction quench γ → λγ from the centred γ ground state
    mu_c, psi_c = ground_state(V, dx, gam, c, tau=2e-3, steps=args.gs_steps, tol=1e-12,
                               psi0=torch.abs(psi_d), device=dev)
    _, obs_b = evolve(psi_c, V, dx, dt, steps, args.quench * gam, c, record_every=rec,
                      **run)
    w2 = obs_b["width_sq"].sum(1)
    w_br, amp_br, rms_br = fit_frequency(obs_b["t"], w2)
    if dim == 2:
        breathing = {"omega_fit": w_br, "omega_exact": 2.0, "abs_err": abs(w_br - 2.0)}
    else:
        breathing = {"omega_fit": w_br,
                     "omega_limits_gamma0_tf": [2.0, float(np.sqrt(5.0))],
                     "in_limits": bool(2.0 - 0.02 <= w_br <= np.sqrt(5.0) + 0.02)}
    breathing.update({"quench_factor": args.quench, "amplitude_fit": amp_br,
                      "fit_rms": rms_br})

    thr = (timed_throughput(lambda k: evolve(psi_c, V, dx, dt, k, gam, c,
                                             record_every=k, **run), n_pts, steps)
           if dev.type == "cuda" else n_pts * steps / wall_k)
    e_b = obs_b["energy"]
    summary = {
        "config": f"{dim}D TDGPE quench dynamics: {n}^{dim} grid, γ={gam:g}, "
                  f"dt={dt:.2e}, {steps} Strang steps ({args.periods:g} trap periods)",
        "mu_ground": float(mu_c),
        "kohn_dipole": {"omega_fit": w_dip, "omega_exact": 1.0,
                        "abs_err": abs(w_dip - 1.0), "amplitude_fit": amp_dip,
                        "displacement": d, "fit_rms": rms_dip},
        f"breathing_{dim}d": breathing,
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dtype": "complex64" if args.f32 else "complex128",
        "norm_drift": float(np.max(np.abs(obs_k["norm"] - 1.0))),
        "energy_drift_rel": float(np.max(np.abs(e_b / e_b[0] - 1.0))),
        "throughput_grid_pt_steps_per_sec": float(thr),
        "wall_ground_state_s": round(wall_gs, 1),
        "wall_evolve_s": round(wall_k, 1),
    }
    if guard is not None:
        summary["f32_resonance_guard"] = guard

    suffix = "" if dim == 2 else f"_{dim}d"
    out_name = args.out_name or (f"summary_f32{suffix}.json" if args.f32
                                 else f"summary{suffix}.json")
    ref_path = os.path.join(args.out, f"summary{suffix}.json")
    if out_name != f"summary{suffix}.json" and os.path.exists(ref_path):
        with open(ref_path) as f:
            ref = json.load(f)
        if (ref.get("dtype") == "complex128"
                and ref.get("config", "").startswith(f"{dim}D")):
            cmp = {"f64_config": ref["config"],
                   "kohn_omega_f64": ref["kohn_dipole"]["omega_fit"],
                   "kohn_omega_delta": abs(w_dip - ref["kohn_dipole"]["omega_fit"]),
                   "mu_ground_delta": abs(float(mu_c) - ref.get("mu_ground", float(mu_c)))}
            if f"breathing_{dim}d" in ref:
                cmp["breathing_omega_f64"] = ref[f"breathing_{dim}d"]["omega_fit"]
                cmp["breathing_omega_delta"] = abs(w_br - cmp["breathing_omega_f64"])
            summary["vs_f64_reference"] = cmp
    np.savez(os.path.join(args.out, "quench_modes.npz"), t_k=obs_k["t"], cx=cx, d=d,
             w_dip=w_dip, t_b=obs_b["t"], w2=w2, w_br=w_br)
    summary["plot"] = viz.draw(
        lambda plots: draw_quench_modes(args.out, plots),
        f"python -m gpe_tpu_torch.experiments.gpe_dynamics --plots --out {args.out}")
    print(json.dumps(summary, indent=1), flush=True)
    with open(os.path.join(args.out, out_name), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
