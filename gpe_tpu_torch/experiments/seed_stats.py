"""Multi-seed statistics for the paper's parity families, port of
`gpe_tpu/experiments/seed_stats.py`.

Runs the PL-PINN and PL-PINN-R γ-continuation ramps for N seeds (default 6,
at least the reference's 5) per mode as one seed ensemble:
`train_plpinn_modes_packed(modes=[m]*N, seed=s0)` gives run i the seed
s0 + 1000·i, the same base and protocol, and all N ramps advance together
in the run-mode kernels. Specs the run-mode kernels cannot take (the
hard-BC box and Gaussian families) train the same seeds as one
`fit_ensemble` (`_train_seeds_vmapped`).

Per (family, mode, method): per-checkpoint-γ per-seed μ and |Δμ| against
the committed float64 oracle values (the family's
runs/comparison_results_<family>/raw_comparison_results.csv), the per-seed
mean-over-γ |Δμ| and its across-seed median/std/min/max. Writes
runs_torch/seed_stats_<family>.json (or --out).

Run (CUDA):  python -m gpe_tpu_torch.experiments.seed_stats --family p3_harmonic
CPU smoke:   ... --family p3_harmonic --modes 0 --epochs 30 --n-seeds 2 --device cpu
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time
from pathlib import Path

import numpy as np

from gpe_tpu_torch.device import resolve_device
from gpe_tpu_torch.experiments.paper_tables import family as get_family
from gpe_tpu_torch.train.packed import (_pick_m, packed_runs_available,
                                        train_plpinn_modes_packed)
from gpe_tpu_torch.train.problem import packed_eligible

REPO = Path(__file__).resolve().parents[2]


def _oracle_from_csv(out_dir) -> dict:
    """{(mode, γ) -> μ_ref} from the family's committed raw CSV."""
    ref = {}
    with open(os.path.join(out_dir, "raw_comparison_results.csv"),
              newline="") as f:
        for row in csv.DictReader(f):
            ref[(int(row["Mode"]), float(row["Gamma"]))] = float(row["mu_ref"])
    return ref


def _train_seeds_vmapped(spec, ramp, mode, n_seeds, base_seed, epochs, patience,
                         lr_mode, rebase, perturb_const: float = 0.01,
                         check_every: int = 512, verbose: bool = False,
                         device=None) -> dict:
    """train_plpinn's ramp for the seed ensemble of a spec the run-mode
    kernels cannot take (hard-BC box/Gaussian), every seed a run of
    `fit_ensemble`: seed i starts from base_seed + 1000·i (the packed
    path's seeds), pretrain → normal_const → q-scale, warm start, tol = 0
    with best-restore, and with rebase=True each run's own incremental-base
    fold (plpinn._rebase, its generator (base_seed + 1000·i)·1_000_003 + γ
    index) carried through `per_run_batch`. As in the JAX package the
    ensemble steps by autograd of the loss (fit_ensemble's plain route).
    Returns {γ: [μ_best per seed]}."""
    import torch

    from gpe_tpu_torch.models import mlp
    from gpe_tpu_torch.models.mlp import run_slice, stack_runs
    from gpe_tpu_torch.train.loop import fit_ensemble
    from gpe_tpu_torch.train.plpinn import _generator, _rebase, ramp_optimizer
    from gpe_tpu_torch.train.pretrain import pretrain_to_base
    from gpe_tpu_torch.train.problem import base_triple, make_batch, make_loss_fn

    dev = resolve_device(device)
    batch = make_batch(spec, mode, device=dev)
    loss_fn = make_loss_fn(spec)
    target = base_triple(spec, mode, batch["x"]).value
    params_list, scales = [], []
    for i in range(n_seeds):
        p = mlp.init_mlp(spec.layers, "xavier_uniform",
                         generator=_generator(base_seed + 1000 * i),
                         dtype=spec.dtype, device=dev)
        p, _ = pretrain_to_base(p, batch["x"], target, spec.activation,
                                epochs=2000, lr=1e-3)
        with torch.no_grad():
            const = float(torch.max(mlp.mlp_apply(p, batch["x"], spec.activation)))
        scales.append(perturb_const / const)
        params_list.append(p)
    params_batch = stack_runs(params_list)
    keys = [k for k in ("base_val", "base_grad", "base_lap", "base_bval",
                        "base_val_reflect") if k in batch]
    prb = {k: torch.stack([batch[k]] * n_seeds) for k in keys} if rebase else None
    optimizer = ramp_optimizer(1e-3, lr_mode)
    out = {}
    for gi, gamma in enumerate(ramp):
        ens = fit_ensemble(loss_fn, optimizer, params_batch, batch, gamma, scales,
                           epochs=epochs, tol=0.0, patience=patience,
                           check_every=check_every, per_run_batch=prb)
        params_batch = ens.params
        out[float(gamma)] = [float(m) for m in ens.mu_best]
        if verbose:
            print(f"  γ={gamma:g}: μ=" + " ".join(f"{m:.5f}" for m in out[float(gamma)]),
                  flush=True)
        if rebase:
            new_p, new_prb = [], {k: [] for k in prb}
            for r in range(n_seeds):
                batch_r, p_r = _rebase(
                    spec, dict(batch, **{k: v[r] for k, v in prb.items()}),
                    run_slice(params_batch, r), scales[r],
                    _generator((base_seed + 1000 * r) * 1_000_003 + gi))
                for k in new_prb:
                    new_prb[k].append(batch_r[k])
                new_p.append(p_r)
            params_batch = stack_runs(new_p)
            prb = {k: torch.stack(v) for k, v in new_prb.items()}
    return out


def _write(out: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def run_seed_stats(family: str, modes=None, n_seeds: int = 6,
                   base_seed: int = 42, epochs: int = 5001,
                   patience: int = 2000, ramp_step: float = 0.5,
                   lr_mode: str = "loss_faithful", out_path: str | None = None,
                   verbose: bool = True, device=None) -> dict:
    fam = get_family(family)
    spec, checkpoints = fam["spec"], fam["checkpoints"]
    modes = tuple(modes) if modes else fam["modes"]
    dev = resolve_device(device)
    # the ramp of paper_tables.run_family: 0 → γ_max, a signed step for the
    # attractive family
    step = fam.get("gamma_step", ramp_step)
    gmax = float(checkpoints[-1])
    ramp = [k * step for k in range(int(round(gmax / step)) + 1)]
    if dev.type == "cuda":
        packable = packed_runs_available(spec, n_seeds, device=dev) is not None
    else:        # the kernels' plain versions, as JAX's --interpret skips its gate
        M = _pick_m(spec.layers, n_seeds)
        packable = M >= 2 and packed_eligible(spec, M)
    ref = _oracle_from_csv(REPO / "runs" / f"comparison_results_{family}")
    path = out_path or str(REPO / "runs_torch" / f"seed_stats_{family}.json")

    cps = [float(g) for g in checkpoints
           if any(abs(float(g) - r) < 1e-9 for r in ramp)]
    out = {"family": family, "n_seeds": n_seeds,
           "seeds": [base_seed + 1000 * i for i in range(n_seeds)],
           "device": str(dev),
           "protocol": {"epochs": epochs, "patience": patience,
                        "ramp_step": step, "lr_mode": lr_mode,
                        "checkpoints": cps},
           "modes": {}}
    t0 = time.time()
    for mode in modes:
        per_mode = {}
        for method, rebase in (("PL-PINN", False), ("PL-PINN-R", True)):
            t1 = time.time()
            if packable:
                res = train_plpinn_modes_packed(
                    spec, ramp, modes=[mode] * n_seeds, epochs=epochs, tol=0.0,
                    patience=patience, seed=base_seed, keep_params=False,
                    rebase=rebase, lr_mode=lr_mode, device=dev)
                # mu_table[mode] lists the runs flattened in ramp order:
                # [(γ0, s0), (γ0, s1), …, (γ0, sN-1), (γ1, s0), …]
                flat = res.mu_table[mode]
                assert len(flat) == len(ramp) * n_seeds
                mu_by_gamma = {float(g): [m for _, m in
                                          flat[gi * n_seeds:(gi + 1) * n_seeds]]
                               for gi, g in enumerate(ramp)}
            else:   # hard-BC specs (box/Gaussian): the fit_ensemble seed ensemble
                mu_by_gamma = _train_seeds_vmapped(
                    spec, ramp, mode, n_seeds, base_seed, epochs, patience,
                    lr_mode, rebase, device=dev)
            rows = []
            per_seed_errs = np.zeros((n_seeds, len(cps)))
            for ci, g in enumerate(cps):
                mus = np.asarray(mu_by_gamma[g])
                errs = np.abs(mus - ref[(mode, g)])
                per_seed_errs[:, ci] = errs
                rows.append({"gamma": g, "mu_ref": ref[(mode, g)],
                             "mu_seeds": mus.tolist(),
                             "abs_err_median": float(np.median(errs)),
                             "abs_err_std": float(np.std(errs))})
            mean_errs = per_seed_errs.mean(axis=1)       # parity cell per seed
            per_mode[method] = {
                "rows": rows,
                "mean_abs_err_per_seed": mean_errs.tolist(),
                "cell_median": float(np.median(mean_errs)),
                "cell_std": float(np.std(mean_errs)),
                "cell_min": float(mean_errs.min()),
                "cell_max": float(mean_errs.max()),
                "wall_s": round(time.time() - t1, 1),
            }
            if verbose:
                print(f"{family} mode {mode} {method}: cell "
                      f"{per_mode[method]['cell_median']:.3e} "
                      f"± {per_mode[method]['cell_std']:.1e} "
                      f"(range {mean_errs.min():.2e}–{mean_errs.max():.2e}, "
                      f"{per_mode[method]['wall_s']}s)", flush=True)
        out["modes"][str(mode)] = per_mode
        # written after every mode, so a cut run keeps the finished modes
        out["partial"] = True
        out["wall_s"] = round(time.time() - t0, 1)
        _write(out, path)
    out.pop("partial", None)
    out["wall_s"] = round(time.time() - t0, 1)
    _write(out, path)
    print(json.dumps({"written": path, "wall_s": out["wall_s"]}), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="p3_harmonic")
    ap.add_argument("--modes", default=None,
                    help="comma-separated subset (default: family modes)")
    ap.add_argument("--n-seeds", type=int, default=6,
                    help="a multiple of the lane pack M (2 for width 64); 6 (>= "
                         "the reference's 5) is the default")
    ap.add_argument("--base-seed", type=int, default=42)
    ap.add_argument("--epochs", type=int, default=5001)
    ap.add_argument("--patience", type=int, default=2000)
    ap.add_argument("--ramp-step", type=float, default=0.5)
    ap.add_argument("--lr-mode", default="loss_faithful")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain versions")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    modes = [int(m) for m in args.modes.split(",")] if args.modes else None
    run_seed_stats(args.family, modes=modes, n_seeds=args.n_seeds,
                   base_seed=args.base_seed, epochs=args.epochs,
                   patience=args.patience, ramp_step=args.ramp_step,
                   lr_mode=args.lr_mode, out_path=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
