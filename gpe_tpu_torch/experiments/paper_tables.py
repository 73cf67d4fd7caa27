"""The paper's comparison tables, port of `gpe_tpu/experiments/paper_tables.py`:
per family, mode and checkpoint γ, the μ of each method against a float64
Newton-continuation FDM oracle, in the JAX package's files
(`raw_comparison_results.csv`, `paper_style_results.csv`,
`comparison_table.{csv,tex}`, `summary.json`).

Methods (`METHOD_ORDER`), each with the reference budget (≤ 5001 epochs a
γ, early stop, best-restore):
- PL-PINN: the γ-continuation ramp (Δγ = 0.5), μ read at the checkpoints;
- PL-PINN-R: the rebased ramp; PL-PINN-R+LM its LM polish of a copy at
  each checkpoint;
- PL-PINN+LM: an LM polish of PL-PINN's best params at each checkpoint;
- Curriculum Training: a direct net pretrained on the base, warm-started
  over the checkpoints;
- Vanilla PINN: one pretrain, then ONE ensemble over the checkpoint γs.

Each family is one spec at the paper's widths (4,000 points, [1,64,64,64,1]
shifted_tanh, p-power nonlinearity), its modes and the checkpoint γ values
its cells are scored at. On the card the PL ramps and the curriculum run on
K1/K2 and the vanilla ensemble on their run mode (K3); the box and Gaussian
families are hard-BC (ψ = base + s·sin(πx)·N), which the fused kernels do
not model: they train on the plain autograd path, as in the JAX package.
`summary.json` adds, per method, its seconds and (on the card) its kernel
launches.

Run: python -m gpe_tpu_torch.experiments.paper_tables --family p3_harmonic
(writes runs_torch/comparison_results_<family>; `--device cpu` on the CPU).
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time

CHECKPOINTS = (0.0, 20.0, 40.0, 60.0, 80.0, 100.0)


def _families():
    from gpe_tpu_torch.train.problem import GPESpec

    paper = dict(n_points=4000, layers=(1, 64, 64, 64, 1),
                 activation="shifted_tanh", kinetic=1.0, nonlinearity="power",
                 bc_weight=10.0, norm_weight=20.0)
    harmonic = dict(lb=-10.0, ub=10.0, potential="harmonic", basis="hermite")
    return {
        "p3_harmonic": dict(spec=GPESpec(p=3.0, **harmonic, **paper),
                            modes=(0, 1, 2, 3, 4, 5), checkpoints=CHECKPOINTS),
        # the direct-net baselines of the box family (μ up to ~500) run with
        # warmup_cosine at lr 1e-3 (the JAX package's A/B,
        # runs/ab_box_baselines/summary.json)
        "p3_box": dict(spec=GPESpec(lb=0.0, ub=1.0, potential="box", basis="box",
                                    hard_bc=True, p=3.0, **paper),
                       modes=(0, 1, 2, 3, 4, 5), checkpoints=CHECKPOINTS,
                       baseline=dict(lr=1e-3, lr_mode="warmup_cosine")),
        # the Δγ = 0.5 ramp of every family (the reference's gravity ramp is
        # Δγ = 0.25)
        "p3_gravity_well": dict(spec=GPESpec(lb=0.0, ub=35.0, potential="linear",
                                             basis="airy", p=3.0, **paper),
                                modes=(0, 1, 2, 3, 4, 5), checkpoints=CHECKPOINTS),
        # γ grid of the reference artifact (0 … −20 step −4, modes 0–5)
        "neg_p3_harmonic": dict(spec=GPESpec(p=3.0, **harmonic, **paper),
                                modes=(0, 1, 2, 3, 4, 5),
                                checkpoints=(0.0, -4.0, -8.0, -12.0, -16.0, -20.0),
                                gamma_step=-0.5),
        "p4_harmonic": dict(spec=GPESpec(p=4.0, **harmonic, **paper),
                            modes=(0, 1, 2, 3, 4, 5), checkpoints=CHECKPOINTS),
        "p8_harmonic": dict(spec=GPESpec(p=8.0, **harmonic, **paper),
                            modes=(0,), checkpoints=CHECKPOINTS),
        "p16_harmonic": dict(spec=GPESpec(p=16.0, **harmonic, **paper),
                             modes=(0,), checkpoints=CHECKPOINTS),
        # a Gaussian bump V = exp(−x²/2) in the unit box on the box base,
        # hard BC (the reference's hardest family)
        "p3_gaussian": dict(spec=GPESpec(lb=0.0, ub=1.0, potential="gaussian",
                                         potential_kwargs=(("sigma", 1.0),),
                                         basis="box", hard_bc=True, p=3.0, **paper),
                            modes=(0,), checkpoints=CHECKPOINTS),
    }


def family(name: str) -> dict:
    """The family `name`: {"spec", "modes", "checkpoints"[, "gamma_step",
    "baseline"]}."""
    fams = _families()
    if name not in fams:
        raise KeyError(f"unknown family {name!r}; have {sorted(fams)}")
    return fams[name]


METHOD_ORDER = ("PL-PINN", "PL-PINN-R", "PL-PINN+LM", "PL-PINN-R+LM",
                "Curriculum Training", "Vanilla PINN")
_REUSE = {"only_baselines": ("PL-PINN", "PL-PINN-R", "PL-PINN+LM"),
          "only_plrlm": ("PL-PINN", "PL-PINN+LM", "Curriculum Training",
                         "Vanilla PINN")}


def _oracle_mu(spec, mode, gammas, device=None) -> dict:
    """{γ: μ} of the float64 Newton-continuation FDM oracle on 2000 points.
    V is evaluated on the f32 grid and widened to float64, as the JAX
    package's potential computes it: the committed tables' mu_ref are then
    met exactly."""
    import numpy as np
    import torch

    from gpe_tpu_torch.physics import potentials
    from gpe_tpu_torch.validate.fdm import solve_gpe_excited_1d

    x = np.linspace(spec.lb, spec.ub, 2000)
    vfn = potentials.get_potential(spec.potential, **dict(spec.potential_kwargs))
    V = vfn(torch.as_tensor(x[:, None], dtype=torch.float32)).numpy().astype(np.float64)
    out = {}
    for g in gammas:
        mu, _ = solve_gpe_excited_1d(V, x[1] - x[0], float(g), mode,
                                     kinetic=spec.kinetic, p=spec.p,
                                     nonlinearity=spec.nonlinearity,
                                     gamma_step=2.0, device=device)
        out[float(g)] = float(mu)
    return out


def _lm_polish_mus(spec, mode, checkpoints, pl_result, normal_const,
                   perturb_const: float = 0.01, steps: int = 120,
                   cg_iters: int = 80, device=None) -> dict:
    """LM-polish PL-PINN's best params at each checkpoint γ; {γ: μ}."""
    import torch

    from gpe_tpu_torch.models.mlp import params_from_numpy
    from gpe_tpu_torch.train.gauss_newton import make_gpe_residual_fn, make_lm_solver
    from gpe_tpu_torch.train.problem import make_batch, make_loss_fn

    batch = make_batch(spec, mode, device=device)
    loss_fn = make_loss_fn(spec)
    rfn = make_gpe_residual_fn(spec)
    scale = perturb_const / normal_const
    lm = None
    out = {}
    for g in checkpoints:
        params = params_from_numpy(pl_result.params_by_mode[mode][g], device=device,
                                   dtype=spec.dtype)
        if lm is None:
            lm = make_lm_solver(rfn, params, steps=steps, cg_iters=cg_iters)
        res = lm(params, batch, g, scale)
        with torch.no_grad():
            out[g] = float(loss_fn(res.params, batch, g, scale)[1]["mu"])
    return out


def _read_raw(out_dir) -> list:
    with open(os.path.join(out_dir, "raw_comparison_results.csv"), newline="") as f:
        return list(csv.DictReader(f))


def _reuse_table(out_dir, modes, checkpoints, needed) -> dict:
    """{(mode, γ): {method: μ}} from the existing raw CSV; raises when a
    needed column is missing at some (mode, γ)."""
    reuse = {}
    for row in _read_raw(out_dir):
        key = (int(row["Mode"]), float(row["Gamma"]))
        reuse.setdefault(key, {})[row["Method"]] = float(row["mu"])
    missing = [(m, g, meth) for m in modes for g in checkpoints for meth in needed
               if meth not in reuse.get((m, g), {})]
    if missing:
        raise ValueError(f"the raw CSV lacks reusable rows (first few: "
                         f"{missing[:4]}); rerun the family without reuse")
    return reuse


def run_family(family: str, out_dir: str, epochs: int = 5001,
               tol: float = 0.0, patience: int = 2000,
               ramp_step: float = 0.5, seed: int = 42,
               lr_mode: str = "loss_faithful", packed: bool = False,
               baseline_lr: float | None = None,
               baseline_lr_mode: str | None = None,
               only_baselines: bool = False, only_plrlm: bool = False,
               modes_filter=None, verbose: bool = True, device=None) -> dict:
    """One family's comparison tables into `out_dir`, on `device` (None →
    the CUDA card); the protocol of the JAX package's `run_family`.

    tol=0 (default) runs every PL method to the full budget and keeps the
    best state; the curriculum keeps tol ≥ 1e-5, and with tol=0 patience is
    off for both baselines. baseline_lr / baseline_lr_mode: the direct-net
    baselines' protocol, by default the family's `baseline` override, else
    (1e-4, lr_mode). packed=True trains the PL ramps of all modes as one
    run-stacked ensemble (`train_plpinn_modes_packed`) where the spec
    allows. only_baselines=True reuses the PL columns of the existing
    out_dir/raw_comparison_results.csv and retrains the baselines;
    only_plrlm=True reuses every other column and retrains the rebased ramp
    with its checkpoint polish. modes_filter reruns those modes only and
    merges their rows with the other modes' rows of the existing raw CSV.
    Returns the summary: {"family", "pl_pinn_mean_abs_err", "wall_s",
    "seconds" per method and, on the card, "launches" per method}."""
    import numpy as np

    from gpe_tpu_torch.device import pin_full_f32, resolve_device
    from gpe_tpu_torch.kernels._common import LaunchCounter
    from gpe_tpu_torch.train import train_plpinn
    from gpe_tpu_torch.train.compare import (train_curriculum_ramp,
                                             train_vanilla_checkpoints)
    from gpe_tpu_torch.utils.metrics import write_error_table

    pin_full_f32()
    dev = resolve_device(device)
    fam = _families()[family]
    bl = fam.get("baseline", {})
    if baseline_lr is None:
        baseline_lr = bl.get("lr", 1e-4)
    if baseline_lr_mode is None:
        baseline_lr_mode = bl.get("lr_mode", lr_mode)
    spec, modes = fam["spec"], fam["modes"]
    if modes_filter is not None:
        modes = tuple(m for m in modes if m in set(modes_filter))
        if not modes:
            raise ValueError(f"modes_filter {modes_filter} matches none of "
                             f"{fam['modes']}")
    checkpoints = [float(g) for g in fam["checkpoints"]]
    step = fam.get("gamma_step", ramp_step)
    ramp = [k * step for k in range(int(round(checkpoints[-1] / step)) + 1)]

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    preserved = []
    raw_path = os.path.join(out_dir, "raw_comparison_results.csv")
    if modes_filter is not None and os.path.exists(raw_path):
        preserved = [{"Method": row["Method"], "Mode": int(row["Mode"]),
                      "Gamma": float(row["Gamma"]), "mu": float(row["mu"]),
                      "mu_ref": float(row["mu_ref"]),
                      "Abs Error": float(row["Abs Error"]),
                      "Rel Error": float(row["Rel Error"])}
                     for row in _read_raw(out_dir) if int(row["Mode"]) not in modes]

    mu_ref = {m: _oracle_mu(spec, m, checkpoints, device=dev) for m in modes}
    if verbose:
        print("oracle:", json.dumps({str(m): mu_ref[m] for m in modes}), flush=True)

    if only_baselines and only_plrlm:
        raise ValueError("pick one of only_baselines/only_plrlm")
    reuse = None
    if only_baselines or only_plrlm:
        reuse = _reuse_table(out_dir, modes, checkpoints,
                             _REUSE["only_plrlm" if only_plrlm else "only_baselines"])

    seconds, launches = {}, {}
    counter = LaunchCounter(runs=True) if dev.type == "cuda" else None

    def timed(method, fn):
        """fn() with its wall time (and kernel launches) added to method's."""
        t1 = time.perf_counter()
        if counter is not None:
            counter.mark()
        out = fn()
        seconds[method] = seconds.get(method, 0.0) + time.perf_counter() - t1
        if counter is not None:
            for k, v in counter.since().items():
                launches.setdefault(method, {}).setdefault(k, 0)
                launches[method][k] += v
        return out

    pl_kw = dict(epochs=epochs, tol=tol, patience=patience, seed=seed,
                 lr_mode=lr_mode, verbose=False)
    pl_all = plr_all = None
    if packed and not only_baselines and len(modes) >= 2:
        from gpe_tpu_torch.train.packed import (packed_runs_available,
                                                train_plpinn_modes_packed)
        if packed_runs_available(spec, len(modes), device=dev):
            pl_all = timed("PL-PINN", lambda: train_plpinn_modes_packed(
                spec, ramp, modes=modes, keep_params=True, device=dev, **pl_kw))
            plr_all = timed("PL-PINN-R", lambda: train_plpinn_modes_packed(
                spec, ramp, modes=modes, keep_params=False, rebase=True,
                device=dev, **pl_kw))
        elif verbose:
            print("packed requested but spec ineligible; per-mode fallback",
                  flush=True)

    bl_patience = patience if tol > 0 else 10**9
    bl_kw = dict(epochs=epochs, patience=bl_patience, seed=seed, lr=baseline_lr,
                 lr_mode=baseline_lr_mode, device=dev)
    raw_rows = []
    for mode in modes:
        got = {}
        if reuse is not None:
            got = {meth: {g: reuse[(mode, g)][meth] for g in checkpoints
                          if meth in reuse.get((mode, g), {})}
                   for meth in METHOD_ORDER}
        if only_plrlm:
            plr = timed("PL-PINN-R", lambda: train_plpinn(
                spec, ramp, modes=(mode,), keep_params=False, rebase=True,
                polish_checkpoints=checkpoints, device=dev, **pl_kw))
            got["PL-PINN-R"] = dict(plr.mu_table[mode])
            got["PL-PINN-R+LM"] = (plr.polished.get(mode, {}) or {}).get("by_gamma", {})
        elif not only_baselines:
            if pl_all is not None:
                pl, plr = pl_all, plr_all
            else:
                pl = timed("PL-PINN", lambda: train_plpinn(
                    spec, ramp, modes=(mode,), keep_params=True, device=dev, **pl_kw))
                plr = timed("PL-PINN-R", lambda: train_plpinn(
                    spec, ramp, modes=(mode,), keep_params=False, rebase=True,
                    polish_checkpoints=checkpoints, device=dev, **pl_kw))
            got["PL-PINN"] = dict(pl.mu_table[mode])
            got["PL-PINN-R"] = dict(plr.mu_table[mode])
            got["PL-PINN+LM"] = timed("PL-PINN+LM", lambda: _lm_polish_mus(
                spec, mode, checkpoints, pl, pl.constant_history[mode], device=dev))
            got["PL-PINN-R+LM"] = (plr.polished.get(mode, {}) or {}).get("by_gamma", {})
        if not only_plrlm:
            # the curriculum keeps the reference's tol = 1e-5 early exit:
            # excited modes are unstable minima of a direct net, and a
            # drifting fit run to the full budget lets best-restore lock in
            # a decayed lower mode
            got["Curriculum Training"] = timed(
                "Curriculum Training", lambda: train_curriculum_ramp(
                    spec, checkpoints, mode, tol=max(tol, 1e-5), **bl_kw))
            got["Vanilla PINN"] = timed(
                "Vanilla PINN", lambda: train_vanilla_checkpoints(
                    spec, checkpoints, mode, tol=tol, **bl_kw))
        for g in checkpoints:
            ref = mu_ref[mode][g]
            for method in METHOD_ORDER:
                if g not in got.get(method, {}):
                    continue           # column absent (packed or older reuse)
                mu = got[method][g]
                err = abs(mu - ref)
                raw_rows.append({"Method": method, "Mode": mode, "Gamma": g,
                                 "mu": mu, "mu_ref": ref, "Abs Error": err,
                                 "Rel Error": 100 * err / max(abs(ref), 1e-30)})
            if verbose:
                print(f"mode {mode} γ={g:g}: ref={ref:.6f} " + " ".join(
                    f"{k}={got[k][g]:.6f}" for k in METHOD_ORDER
                    if g in got.get(k, {})), flush=True)

    # per (mode, method) means over γ, from the raw rows (preserved + fresh)
    raw_rows = preserved + raw_rows
    midx = {m: i for i, m in enumerate(METHOD_ORDER)}
    raw_rows.sort(key=lambda r: (r["Mode"], r["Gamma"], midx.get(r["Method"], 99)))
    by_mm = {}
    for r in raw_rows:
        by_mm.setdefault((r["Mode"], r["Method"]), []).append(r)
    rows = [{"Mode": f"Mode {mode}", "Method": method,
             "abs_err": float(np.mean([e["Abs Error"] for e in by_mm[(mode, method)]])),
             "rel_err_pct": float(np.mean([e["Rel Error"] for e in by_mm[(mode, method)]]))}
            for mode, method in sorted(by_mm, key=lambda k: (k[0], midx.get(k[1], 99)))]

    with open(os.path.join(out_dir, "paper_style_results.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["Mode", "Method", "abs_err", "rel_err_pct"])
        w.writeheader()
        for r in rows:
            w.writerow({**r, "abs_err": f"{r['abs_err']:.2e}",
                        "rel_err_pct": f"{r['rel_err_pct']:.4g}%"})
    with open(raw_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(raw_rows[0]))
        w.writeheader()
        w.writerows(raw_rows)
    write_error_table(
        [{"mode": r["Mode"], "method": r["Method"], "mu": r["mu"],
          "mu_ref": r["mu_ref"], "gamma": r["Gamma"]} for r in raw_rows],
        out_dir, stem="comparison_table")

    summary = {"family": family,
               "pl_pinn_mean_abs_err": {r["Mode"]: r["abs_err"] for r in rows
                                        if r["Method"] == "PL-PINN"},
               "wall_s": round(time.time() - t0, 1),
               "seconds": seconds}
    if counter is not None:
        summary["launches"] = launches
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"rows": rows, "summary": summary}, f, indent=2)
    if verbose:
        print(json.dumps(summary), flush=True)
    return summary


_LR_MODES = ("loss_faithful", "cosine", "constant", "warmup_faithful",
             "warmup_cosine")


def main(argv=None):
    ap = argparse.ArgumentParser(description="the paper's comparison tables")
    ap.add_argument("--family", default="p3_harmonic", choices=sorted(_families()))
    ap.add_argument("--out", default=None,
                    help="output directory (default runs_torch/comparison_results_"
                         "<family>; the port never writes under runs/)")
    ap.add_argument("--epochs", type=int, default=5001)
    ap.add_argument("--ramp-step", type=float, default=0.5)
    ap.add_argument("--lr-mode", default="loss_faithful", choices=_LR_MODES)
    ap.add_argument("--modes", default=None,
                    help="comma-separated mode subset: rerun only these modes "
                         "and merge with the existing raw CSV")
    ap.add_argument("--packed", action="store_true",
                    help="train the PL ramps of all modes as one run-stacked ensemble")
    ap.add_argument("--baseline-lr", type=float, default=None,
                    help="base LR of the curriculum/vanilla baselines (default: "
                         "the family's baseline override, else 1e-4)")
    ap.add_argument("--baseline-lr-mode", default=None, choices=_LR_MODES,
                    help="LR schedule of the baselines (default: the family "
                         "override, else --lr-mode)")
    ap.add_argument("--only-baselines", action="store_true",
                    help="reuse the PL columns of the existing raw CSV and "
                         "retrain only the baselines")
    ap.add_argument("--only-plrlm", action="store_true",
                    help="reuse every other column and retrain only the rebased "
                         "ramp with its checkpoint LM polish")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--patience", type=int, default=2000)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    out = args.out or os.path.join("runs_torch", f"comparison_results_{args.family}")
    mf = [int(m) for m in args.modes.split(",")] if args.modes else None
    run_family(args.family, out, epochs=args.epochs, ramp_step=args.ramp_step,
               seed=args.seed, patience=args.patience, lr_mode=args.lr_mode,
               packed=args.packed, baseline_lr=args.baseline_lr,
               baseline_lr_mode=args.baseline_lr_mode,
               only_baselines=args.only_baselines, only_plrlm=args.only_plrlm,
               modes_filter=mf, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
