"""CLI experiment runner, port of `gpe_tpu/experiments/run.py`'s `plpinn`,
`fit`, `cross_potential`, `compare`, `two_stage`, `beta_sweep`, `p_ramp`,
`deflation`, `relobralo`, `optimizer_sweep`, `helmholtz` and `deeponet`
branches:

    python -m gpe_tpu_torch.experiments.run <name> [--train] [--epochs N]
        [--gammas G ...] [--betas B ...] [--modes M ...] [--pretrain N]
        [--seed S] [--lm-steps N] [--lbfgs-steps N] [--out DIR] [--cpu]
        [--plots] [--list]

- `plpinn`: train-or-load the bundle `<out>/<name>/bundle.pkl` (`--train`
  forces a fresh run), run `train_plpinn` with the config's `rebase` and
  `lm_polish`, score a 2D harmonic run's LM-polished μ against the
  imaginary-time oracle (384² grid, τ 2e-3, Richardson order 2); one JSON
  line with the JAX record's keys (`experiment`, `mu_table_tail`,
  `lm_polished` with `mu_ref`/`mu_abs_err`, `mesh_devices`, `wall_s`). A
  `use_mesh` config (`plpinn_sharded_dp`) shards the collocation points
  over the ranks of the process group that `torchrun` describes
  (`torchrun --nproc_per_node N -m gpe_tpu_torch.experiments.run
  plpinn_sharded_dp`; NCCL on the card, gloo with `--cpu`), or over a
  world-size-1 group in a plain process; rank 0 alone writes and prints.
- `fit`: one model trained per γ of the config, warm-started from the last
  iterate, by Adam (clip 1.0) on the spec's loss (self-adaptive weighting,
  anti-trivial and Riesz terms, disk geometry); one JSON line per γ with
  the JAX record's keys (`gamma`, `mu`, `loss`, `epochs`), μ of the
  normalised best state for a vanilla spec.
- `cross_potential`: the mode-0 γ ramp of each potential family (harmonic,
  box, gravity well, Gaussian trap), each trained or loaded from
  `<out>/<name>/<family>_bundle.pkl`; one JSON line per family with the JAX
  record's keys (`potential`, `mu_final`, `gamma0_final_loss`).
- `compare`: PL-PINN against the vanilla PINN at each γ of the config.
  With n_runs > 1 the multi-seed protocol (`train_multiple_runs`, success
  thresholds PL 1e-11 and vanilla 1e-5): `<out>/<name>/multirun_stats.json`
  keyed by method (by `<method>_g<γ>` when the config has several γ), and
  one JSON line of each key's `mu_median`/`mu_std`; else `compare_methods`,
  one JSON line per γ (`gamma`, each method's `mu` and `loss`). Each
  method pretrains its full 2000 steps, as in the JAX runner, whatever
  `--pretrain` says.
- `two_stage`: `train_two_stage` over the config's β, then its γ at the
  last β (2000 pretrain steps whatever `--pretrain` says, as in the JAX
  runner); one JSON line (`experiment`, `mu_beta`, `mu_gamma`, `wall_s`).
- `beta_sweep`: train-or-load the bundle of `train_beta_sweep` over the
  config's β at its first γ; one JSON line (`experiment`, `mu_table_tail`,
  `wall_s`).
- `p_ramp`: `train_p_ramp` over the config's p at its first γ and mode;
  one JSON line (`experiment`, `mu_table`, `wall_s`).
- `deflation`: `train_deflation` of len(modes) states at the first γ, with
  the JAX runner's orth_weight 500 and 60 LM polish steps (`--lm-steps`
  cuts them); one JSON line (`experiment`, `mu_table`, `wall_s`).
- `relobralo`: `fit_relobralo` per γ of the config, warm-started from the
  last step's params; one JSON line per γ (`gamma`, `mu`, `loss`,
  `lambdas` of the last step by term).
- `optimizer_sweep`: `train_curriculum` over the config's γ (the η ramp)
  once per optimizer of the config; one JSON line per optimizer
  (`optimizer`, `mu_table` as [η, μ] pairs) with `ms_per_step` (the
  sweep's fit seconds over its steps).
- `helmholtz`: `train_helmholtz` on the config's HelmholtzSpec (Adam for
  the config's epochs, `--lbfgs-steps` L-BFGS steps, default 100, then
  `--lm-steps` LM steps, default 120); one JSON line (`experiment`, `k`,
  `test_mae`, `interior_mse`, `k_error`, `wall_s`).
- `deeponet`: `train_deeponet` on 64 potentials of the scaled-harmonic
  family at the config's first γ (`--pretrain` replaces its 3,000
  pretraining steps), then `evaluate_deeponet` on the held-out β grid
  against the float64 FDM oracle; one JSON line with the JAX record's
  keys (`experiment`, `gamma`, `train_mu_range`, `heldout`,
  `interp_max_mu_err`, `interp_max_psi_l2`, `extrap_max_mu_err`,
  `wall_s`) and `plot`.

Every record adds `seconds` (the wall time of each part) and, on the card,
`launches`: the f32 K1 and K2 launches of what it records
(`kernels.fused_residual.collocation_sums.launches`,
`kernels.fused_grad.collocation_grads.launches`) and, for `compare`, of
their run mode (K3: `collocation_sums_runs`, `collocation_grads_runs`).
`<out>/<name>/summary.json` holds the records as the JAX runner writes them
(one record, or the list).

`--lm-steps` defaults to each branch's JAX value (120 for `plpinn` and
`helmholtz`, 60 for `deflation`). `--out` defaults to `runs_torch`; the port never writes
under `runs/`, which holds the JAX package's artifacts. The run is on the CUDA card unless
`--cpu` is given. A failing oracle fails the run. Configurations of the
JAX registry the port cannot build yet, and the other algorithms, raise
NotImplementedError naming what they wait for.

Figures (the JAX runner's): `plpinn` draws `mu_vs_gamma.png`,
`loss_history.png`, `epochs_heatmap.png` and, for a 1D spec,
`wavefunctions.png` (the net of about six γ rungs a mode, evaluated on the
run's device: `wavefunctions_from_bundle`); `beta_sweep` `mu_vs_beta.png`,
`epochs_vs_beta_heatmap.png`, `loss_history.png`; `cross_potential`
`mode0_cross_potential.png`; `optimizer_sweep` `optimizer_comparison.png`
and `deeponet` `deeponet_heldout.png`, each drawn from the arrays the run
saves in `<out>/<name>/<figure>.npz`. Each record of those branches has
`plot`: the files written, or, where the host has no matplotlib (the
card's), the command that draws them. `--plots` trains nothing: it draws
the figures from the saved bundle(s) or `.npz` files (an error names a
missing one), builds no process group, and prints one JSON line
(`experiment`, `plot`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from gpe_tpu_torch import viz
from gpe_tpu_torch.kernels._common import LaunchCounter

ORACLE_GRID = 384
ORACLE_TAU = 2e-3
ORACLE_RICHARDSON = 2


def _plots_command(name: str, out: str) -> str:
    return f"python -m gpe_tpu_torch.experiments.run {name} --plots --out {out} [--cpu]"


def wavefunctions_from_bundle(cfg, bundle, device):
    """The wavefunction figure's arrays (the JAX runner's
    `_plot_wavefunctions_from_bundle`): (x, {mode: {γ: u}}) as numpy, u
    the complete solution of the best params of about six γ rungs a mode
    on `make_batch`'s base, evaluated on `device`; None for a spec that is
    not 1D or a bundle without params."""
    import torch

    from gpe_tpu_torch.models import mlp
    from gpe_tpu_torch.models.ansatz import box_sine_factor
    from gpe_tpu_torch.train.problem import make_batch

    spec = cfg.spec
    if spec.dim != 1 or not bundle["params_by_mode"]:
        return None
    const = bundle["constant_history"]
    u_by, b = {}, None
    for mode, by_g in bundle["params_by_mode"].items():
        if not by_g:
            continue
        b = make_batch(spec, mode, device=device)
        scale = cfg.perturb_const / const[mode] if spec.use_perturbation else 1.0
        gs = sorted(by_g)
        u_by[mode] = {}
        for g in gs[::max(1, len(gs) // 6)]:
            p = mlp.params_from_numpy(by_g[g], device=device, dtype=b["x"].dtype)
            with torch.no_grad():
                v = mlp.mlp_apply(p, b["x"], spec.activation) * scale
                if spec.hard_bc:
                    v = v * box_sine_factor(spec.lb, spec.ub)(b["x"]).value
                if spec.use_perturbation:
                    v = b["base_val"] + v
            u_by[mode][g] = v.cpu().numpy()
    if not u_by:
        return None
    return b["x"][:, 0].cpu().numpy(), u_by


def bundle_figures(cfg, bundles: dict, out_dir: str, device):
    """draw_fn(plots) of a bundle branch's figures: `bundles` maps
    "bundle" (plpinn, beta_sweep) or each cross-potential family to its
    loaded bundle; returns the paths written."""
    def draw_fn(plots):
        plots.use_publication_style()
        if cfg.algorithm == "cross_potential":
            loss = {}
            for label, b in bundles.items():
                g0 = sorted(b["training_history"][0])[0]
                loss[label] = b["training_history"][0][g0]["loss"]
            return [plots.plot_mode0_cross_potential(loss, out_dir, smooth=9)]
        bundle = bundles["bundle"]
        if cfg.algorithm == "beta_sweep":
            return [plots.plot_mu_vs_gamma(bundle["mu_table"], out_dir, "mu_vs_beta.png",
                                           every=1, xlabel="β"),
                    plots.plot_epochs_heatmap(bundle["epochs_history"], out_dir,
                                              "epochs_vs_beta_heatmap.png", xlabel="β"),
                    plots.plot_loss_history(bundle["training_history"], out_dir)]
        paths = [plots.plot_mu_vs_gamma(bundle["mu_table"], out_dir),
                 plots.plot_loss_history(bundle["training_history"], out_dir),
                 plots.plot_epochs_heatmap(bundle["epochs_history"], out_dir)]
        wf = wavefunctions_from_bundle(cfg, bundle, device)
        if wf is not None:
            paths.append(plots.plot_wavefunctions(*wf, out_dir))
        return paths
    return draw_fn


def draw_optimizer_comparison(out_dir: str, plots) -> list:
    """optimizer_comparison.png from the sweep's loss histories saved in
    `<out_dir>/optimizer_comparison.npz` (the last η's, one curve per
    optimizer in the sweep's order)."""
    d = np.load(viz.saved(os.path.join(out_dir, "optimizer_comparison.npz")))
    plots.use_publication_style()
    return [plots.plot_method_comparison({str(n): d[f"loss_{n}"] for n in d["names"]},
                                         out_dir, "optimizer_comparison.png")]


def draw_deeponet_heldout(out_dir: str, plots) -> list:
    """deeponet_heldout.png from the held-out evaluation's arrays saved in
    `<out_dir>/deeponet_heldout.npz`: μ against β beside the FDM oracle,
    and |ψ| of the first, middle and last held-out β."""
    d = np.load(viz.saved(os.path.join(out_dir, "deeponet_heldout.npz")))
    plt = plots.plt
    plots.use_publication_style()
    beta, u_pred, x = d["beta"], d["u_pred"], d["x"]
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    axes[0].plot(beta, d["mu_ref"], "k-", label="FDM oracle")
    axes[0].plot(beta, d["mu_pred"], "o", ms=5, label="DeepONet")
    axes[0].set_xlabel(r"$\beta$"); axes[0].set_ylabel(r"$\mu$")
    axes[0].legend(); axes[0].set_title("held-out potentials")
    for i in (0, len(beta) // 2, len(beta) - 1):
        dxg = x[1] - x[0]
        psi = u_pred[i] / np.sqrt(np.sum(u_pred[i] ** 2) * dxg)
        axes[1].plot(x, np.abs(psi), label=rf"$\beta$={beta[i]:.2f}")
    axes[1].set_xlabel("x"); axes[1].set_ylabel(r"$|\psi|$")
    axes[1].legend()
    fig.tight_layout()
    path = os.path.join(out_dir, "deeponet_heldout.png")
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return [path]


def _write_summary(out_dir, records):
    """<out_dir>/summary.json as the JAX runner writes it: the record, or
    the list of records when there are several."""
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(records if len(records) != 1 else records[0], f, indent=2,
                  default=str)


def oracle_mu(spec, gamma: float, device=None) -> float:
    """μ of the 2D harmonic trap of `spec` at γ by the imaginary-time oracle
    at the runner's settings (384² grid over [lb, ub]², τ 2e-3, Richardson
    order 2), in float64 on `device`."""
    from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe

    a = dict(spec.potential_kwargs).get("a", 1.0)
    x1 = np.linspace(spec.lb, spec.ub, ORACLE_GRID)
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    mu, _ = imaginary_time_gpe(a * (X**2 + Y**2), x1[1] - x1[0], float(gamma),
                               kinetic=spec.kinetic, p=spec.p, tau=ORACLE_TAU,
                               richardson=ORACLE_RICHARDSON, device=device)
    return float(mu)


def _scored(spec) -> bool:
    return spec.dim == 2 and spec.potential == "harmonic" and not spec.hard_bc


def cross_potential_families(spec):
    """The cross-potential figure's families, each derived from `spec` (the
    paper's 1D spec): the harmonic trap, the box (hard BC, box base), the
    gravity well (linear potential on [0, 35], Airy base) and a Gaussian
    trap on the Hermite base."""
    replace = dataclasses.replace
    return {
        "harmonic": spec,
        "box": replace(spec, lb=0.0, ub=1.0, potential="box", basis="box",
                       hard_bc=True),
        "gravity_well": replace(spec, lb=0.0, ub=35.0, potential="linear",
                                basis="airy"),
        "gaussian": replace(spec, potential="gaussian"),
    }


def _train(cfg, spec, modes, dev, lm_steps, mesh=None):
    from gpe_tpu_torch.train import train_plpinn

    return train_plpinn(spec, cfg.gamma_values, modes, epochs=cfg.epochs,
                        tol=cfg.tol, patience=cfg.patience,
                        perturb_const=cfg.perturb_const, lr=cfg.lr, seed=cfg.seed,
                        pretrain_epochs=cfg.pretrain_epochs, rebase=cfg.rebase,
                        mesh=mesh, lm_polish=cfg.lm_polish,
                        lm_steps=120 if lm_steps is None else lm_steps,
                        verbose=True, device=dev)


def _mesh(cpu: bool):
    """The collocation mesh of a `use_mesh` config: the group `torchrun`
    describes, else a world-size-1 group; gloo on the CPU, NCCL on the card."""
    from gpe_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    backend = "gloo" if cpu else "nccl"
    initialize_multihost(backend=backend)
    mesh = make_mesh(device="cpu" if cpu else None, backend=backend)
    if mesh.rank == 0:
        print(f"mesh: {mesh.size} ranks ({backend}), the collocation points "
              f"sharded on axis {mesh.axis_names[0]!r}", flush=True)
    return mesh


def _run_plpinn(cfg, args, dev, out_dir, emit, mesh=None):
    from gpe_tpu_torch.io import load_bundle, save_bundle

    bundle_path = os.path.join(out_dir, "bundle.pkl")
    launches = LaunchCounter()
    t0 = time.time()
    polished, seconds = None, {}
    if args.train or not os.path.exists(bundle_path):
        res = _train(cfg, cfg.spec, cfg.modes, dev, args.lm_steps, mesh)
        polished, seconds = res.polished, dict(res.seconds)
        if mesh is None or mesh.rank == 0:
            save_bundle(bundle_path, res, cfg.spec)
    if mesh is not None and mesh.rank != 0:
        return
    bundle = load_bundle(bundle_path)
    extra = {}
    if mesh is not None:
        extra["mesh_devices"] = mesh.size
    if polished:
        extra["lm_polished"] = {
            m: {k: v for k, v in pol.items() if k not in ("params", "base_val")}
            for m, pol in polished.items()}
        if _scored(cfg.spec):
            seconds["oracle"] = {}
            for m, pol in extra["lm_polished"].items():
                t1 = time.perf_counter()
                pol["mu_ref"] = oracle_mu(cfg.spec, pol["gamma"], device=dev)
                pol["mu_abs_err"] = abs(pol["mu"] - pol["mu_ref"])
                seconds["oracle"][m] = time.perf_counter() - t1
                print(f"mode {m}: oracle μ_ref={pol['mu_ref']:.12f} "
                      f"({seconds['oracle'][m]:.2f} s), |μ − μ_ref| = "
                      f"{pol['mu_abs_err']:.3e}")
    record = {"experiment": cfg.name,
              "mu_table_tail": {str(m): v[-1] for m, v in bundle["mu_table"].items()},
              **extra,
              "wall_s": round(time.time() - t0, 1)}
    if seconds:
        record["seconds"] = seconds
    if dev.type == "cuda":
        record["launches"] = launches.since()
    record["plot"] = viz.draw(bundle_figures(cfg, {"bundle": bundle}, out_dir, dev),
                              _plots_command(cfg.name, args.out))
    emit(record)


def _run_fit(cfg, dev, emit):
    import torch

    from gpe_tpu_torch.train.deflation import _normalized_mu
    from gpe_tpu_torch.train.loop import fit
    from gpe_tpu_torch.train.optimizers import make_optimizer
    from gpe_tpu_torch.train.problem import (init_params, make_batch, make_loss_fn,
                                             net_params)

    spec = cfg.spec
    batch = make_batch(spec, cfg.modes[0], device=dev)
    loss_fn = make_loss_fn(spec)
    params = init_params(spec, torch.Generator().manual_seed(cfg.seed), device=dev)
    opt = make_optimizer("adam", cfg.lr, clip_norm=1.0)
    launches = LaunchCounter()
    for g in cfg.gamma_values:
        launches.mark()
        t0 = time.perf_counter()
        res = fit(loss_fn, opt, params, batch, g, 1.0, epochs=cfg.epochs,
                  tol=cfg.tol, patience=cfg.patience)
        params = res.final_params
        # μ of the NORMALISED best state for a vanilla spec: the nonlinear
        # term's strength depends on ∫u² = 1, and the raw Rayleigh quotient
        # drifts with the residual normalisation error
        mu = (float(_normalized_mu(spec, net_params(res.params), batch, g))
              if not spec.use_perturbation else res.mu_best)
        record = {"gamma": g, "mu": mu, "loss": res.best_loss,
                  "epochs": res.epochs_run,
                  "seconds": {"fit": time.perf_counter() - t0}}
        if dev.type == "cuda":
            record["launches"] = launches.since()
        emit(record)


def _run_cross_potential(cfg, args, dev, out_dir, emit):
    from gpe_tpu_torch.io import load_bundle, save_bundle

    launches = LaunchCounter()
    bundles, records = {}, []
    for label, fspec in cross_potential_families(cfg.spec).items():
        bpath = os.path.join(out_dir, f"{label}_bundle.pkl")
        launches.mark()
        seconds = {}
        if args.train or not os.path.exists(bpath):
            res = _train(cfg, fspec, (0,), dev, args.lm_steps)
            seconds = dict(res.seconds)
            save_bundle(bpath, res, fspec)
        b = bundles[label] = load_bundle(bpath)
        g0 = sorted(b["training_history"][0])[0]
        record = {"potential": label, "mu_final": b["mu_table"][0][-1],
                  "gamma0_final_loss": float(b["training_history"][0][g0]["loss"][-1])}
        if seconds:
            record["seconds"] = seconds
        if dev.type == "cuda":
            record["launches"] = launches.since()
        records.append(record)
    plot = viz.draw(bundle_figures(cfg, bundles, out_dir, dev),
                    _plots_command(cfg.name, args.out))
    for record in records:
        emit({**record, "plot": plot})


# the reference's success thresholds of the multi-seed protocol
MULTIRUN_THRESHOLDS = {"pl_pinn": 1e-11, "vanilla": 1e-5}


def _run_compare(cfg, dev, out_dir, emit):
    from gpe_tpu_torch.train.compare import compare_methods, train_multiple_runs

    launches = LaunchCounter(runs=True)
    kw = dict(epochs=cfg.epochs, tol=cfg.tol, patience=cfg.patience, device=dev)
    if cfg.n_runs > 1:
        stats, seconds, counts = {}, {}, {}
        for g in cfg.gamma_values:
            for m, thr in MULTIRUN_THRESHOLDS.items():
                # key by (method, γ): a bare method key would keep only the
                # last γ's statistics of a multi-γ config
                key = f"{m}_g{g:g}" if len(cfg.gamma_values) > 1 else m
                launches.mark()
                t0 = time.perf_counter()
                stats[key] = train_multiple_runs(
                    cfg.spec, g, n_runs=cfg.n_runs, use_perturbation=(m == "pl_pinn"),
                    success_threshold=thr, **kw)
                seconds[key] = time.perf_counter() - t0
                counts[key] = launches.since()
        summary = {k: {"mu_median": v["mu_median"], "mu_std": v["mu_std"],
                       "mu_runs": [float(x) for x in v["mu_runs"]],
                       "epochs_run": [int(x) for x in v["epochs_run"]]}
                   for k, v in stats.items()}
        with open(os.path.join(out_dir, "multirun_stats.json"), "w") as f:
            json.dump(summary, f, indent=2)
        record = {k: {"mu_median": v["mu_median"], "mu_std": v["mu_std"]}
                  for k, v in summary.items()}
        record["seconds"] = seconds
        if dev.type == "cuda":
            record["launches"] = counts
        emit(record)
        return
    for g in cfg.gamma_values:
        launches.mark()
        t0 = time.perf_counter()
        out = compare_methods(cfg.spec, g, **kw)
        record = {"gamma": g, **{m: {"mu": d["mu"], "loss": d["best_loss"]}
                                 for m, d in out.items()},
                  "seconds": {"compare": time.perf_counter() - t0}}
        if dev.type == "cuda":
            record["launches"] = launches.since()
        emit(record)


def _record(record, seconds, launches, dev):
    """The record with `seconds` and, on the card, the launches since the
    counter's mark."""
    if seconds:
        record["seconds"] = seconds
    if dev.type == "cuda":
        record["launches"] = launches.since()
    return record


def _run_two_stage(cfg, dev, emit):
    from gpe_tpu_torch.train import train_two_stage

    launches = LaunchCounter()
    t0 = time.time()
    res = train_two_stage(cfg.spec, cfg.beta_values, cfg.gamma_values,
                          epochs=cfg.epochs, tol=cfg.tol, patience=cfg.patience,
                          perturb_const=cfg.perturb_const, lr=cfg.lr, seed=cfg.seed,
                          verbose=True, device=dev)
    emit(_record({"experiment": cfg.name, "mu_beta": res.mu_beta,
                  "mu_gamma": res.mu_gamma, "wall_s": round(time.time() - t0, 1)},
                 res.seconds, launches, dev))


def _run_beta_sweep(cfg, args, dev, out_dir, emit):
    from gpe_tpu_torch.io import load_bundle, save_bundle
    from gpe_tpu_torch.train import train_beta_sweep

    bundle_path = os.path.join(out_dir, "bundle.pkl")
    launches = LaunchCounter()
    t0 = time.time()
    seconds = None
    if args.train or not os.path.exists(bundle_path):
        res = train_beta_sweep(cfg.spec, cfg.beta_values, gamma=cfg.gamma_values[0],
                               modes=cfg.modes, epochs=cfg.epochs, tol=cfg.tol,
                               patience=cfg.patience, perturb_const=cfg.perturb_const,
                               lr=cfg.lr, seed=cfg.seed,
                               pretrain_epochs=cfg.pretrain_epochs, verbose=True,
                               device=dev)
        seconds = res.seconds
        save_bundle(bundle_path, res, cfg.spec)
    bundle = load_bundle(bundle_path)
    record = _record({"experiment": cfg.name,
                      "mu_table_tail": {str(m): v[-1] for m, v in bundle["mu_table"].items()},
                      "wall_s": round(time.time() - t0, 1)}, seconds, launches, dev)
    record["plot"] = viz.draw(bundle_figures(cfg, {"bundle": bundle}, out_dir, dev),
                              _plots_command(cfg.name, args.out))
    emit(record)


def _run_p_ramp(cfg, dev, emit):
    from gpe_tpu_torch.train import train_p_ramp

    launches = LaunchCounter()
    t0 = time.time()
    res = train_p_ramp(cfg.spec, cfg.p_values, cfg.gamma_values[0], mode=cfg.modes[0],
                       epochs=cfg.epochs, tol=cfg.tol, patience=cfg.patience,
                       lr=cfg.lr, seed=cfg.seed, pretrain_epochs=cfg.pretrain_epochs,
                       verbose=True, device=dev)
    emit(_record({"experiment": cfg.name, "mu_table": res.mu_table,
                  "wall_s": round(time.time() - t0, 1)}, res.seconds, launches, dev))


def _run_deflation(cfg, args, dev, emit):
    from gpe_tpu_torch.train import train_deflation

    launches = LaunchCounter()
    t0 = time.time()
    res = train_deflation(cfg.spec, cfg.gamma_values[0], n_modes=len(cfg.modes),
                          epochs=cfg.epochs, lr=cfg.lr, seed=cfg.seed,
                          orth_weight=500.0,
                          polish_steps=60 if args.lm_steps is None else args.lm_steps,
                          verbose=True, device=dev)
    emit(_record({"experiment": cfg.name, "mu_table": res.mu_table,
                  "wall_s": round(time.time() - t0, 1)}, res.seconds, launches, dev))


def _run_relobralo(cfg, dev, emit):
    import torch

    from gpe_tpu_torch.train import fit_relobralo
    from gpe_tpu_torch.train.problem import init_params, make_batch

    batch = make_batch(cfg.spec, cfg.modes[0], device=dev)
    params = init_params(cfg.spec, torch.Generator().manual_seed(cfg.seed), device=dev)
    launches = LaunchCounter()
    for g in cfg.gamma_values:
        launches.mark()
        t0 = time.perf_counter()
        res = fit_relobralo(cfg.spec, params, batch, g, epochs=cfg.epochs, lr=cfg.lr,
                            seed=cfg.seed)
        params = res.params
        emit(_record({"gamma": g, "mu": res.mu, "loss": res.best_loss,
                      "lambdas": dict(zip(res.term_names,
                                          res.lambda_history[-1].tolist()))},
                     {"fit": time.perf_counter() - t0}, launches, dev))


def _run_optimizer_sweep(cfg, args, dev, out_dir, emit):
    from gpe_tpu_torch.train.curriculum import train_curriculum

    launches = LaunchCounter()
    records, losses = [], {}
    for name in cfg.optimizers:
        launches.mark()
        res = train_curriculum(cfg.spec, cfg.gamma_values, mode=cfg.modes[0],
                               epochs=cfg.epochs, lr=cfg.lr, seed=cfg.seed,
                               optimizer=name, verbose=True, device=dev)
        fit_s = sum(res.seconds.values())
        losses[f"loss_{name}"] = np.asarray(res.history_by_eta[max(res.history_by_eta)]["loss"])
        record = {"optimizer": name, "mu_table": [[e, m] for e, m in res.mu_table],
                  "ms_per_step": 1e3 * fit_s / sum(res.epochs_by_eta.values())}
        records.append(_record(record, {str(e): t for e, t in res.seconds.items()},
                               launches, dev))
    np.savez(os.path.join(out_dir, "optimizer_comparison.npz"),
             names=np.asarray(cfg.optimizers), **losses)
    plot = viz.draw(lambda plots: draw_optimizer_comparison(out_dir, plots),
                    _plots_command(cfg.name, args.out))
    for record in records:
        emit({**record, "plot": plot})


def _run_helmholtz(cfg, args, dev, emit):
    from gpe_tpu_torch.experiments.configs import helmholtz_specs
    from gpe_tpu_torch.helmholtz.problem import train_helmholtz

    launches = LaunchCounter()
    t0 = time.time()
    res = train_helmholtz(
        helmholtz_specs()[cfg.name], epochs=cfg.epochs, lr=cfg.lr, seed=cfg.seed,
        lbfgs_steps=100 if args.lbfgs_steps is None else args.lbfgs_steps,
        lm_steps=120 if args.lm_steps is None else args.lm_steps, device=dev)
    emit(_record({"experiment": cfg.name, "k": res.k, "test_mae": res.test_mae,
                  "interior_mse": res.interior_mse, "k_error": res.k_error,
                  "wall_s": round(time.time() - t0, 1)}, res.seconds, launches, dev))


# the held-out β grid: strictly between training samples, with mild
# extrapolation at both ends of the training range (0.5, 2.0)
DEEPONET_TEST_BETAS = [0.45, 0.6, 0.77, 0.93, 1.11, 1.34, 1.58, 1.83, 2.1]


def _run_deeponet(cfg, args, dev, out_dir, emit):
    from gpe_tpu_torch.deeponet.model import (DeepONetSpec, evaluate_deeponet,
                                              train_deeponet)

    launches = LaunchCounter()
    t0 = time.time()
    dspec = DeepONetSpec(p=cfg.spec.p if cfg.spec else 3.0)
    gamma = cfg.gamma_values[0]
    t1 = time.perf_counter()
    res = train_deeponet(dspec, gamma=gamma, epochs=cfg.epochs, n_functions=64,
                         seed=cfg.seed, device=dev,
                         pretrain_epochs=3000 if args.pretrain is None else args.pretrain)
    seconds = {"train": time.perf_counter() - t1}
    t1 = time.perf_counter()
    rows, u_pred, x = evaluate_deeponet(dspec, res.params, DEEPONET_TEST_BETAS, gamma)
    seconds["heldout"] = time.perf_counter() - t1
    np.savez(os.path.join(out_dir, "deeponet_heldout.npz"), beta=[r["beta"] for r in rows],
             mu_ref=[r["mu_ref"] for r in rows], mu_pred=[r["mu_pred"] for r in rows],
             u_pred=u_pred, x=x)
    interp = [r for r in rows if 0.5 <= r["beta"] <= 2.0]
    extrap = [r for r in rows if not (0.5 <= r["beta"] <= 2.0)]
    emit(_record({"experiment": cfg.name, "gamma": gamma,
                  "train_mu_range": [float(res.mu_per_fn.min()),
                                     float(res.mu_per_fn.max())],
                  "heldout": rows,
                  # unseen potentials inside the training range against mild
                  # extrapolation beyond it
                  "interp_max_mu_err": max(r["mu_abs_err"] for r in interp),
                  "interp_max_psi_l2": max(r["psi_l2_err"] for r in interp),
                  "extrap_max_mu_err": (max(r["mu_abs_err"] for r in extrap)
                                        if extrap else None),
                  "plot": viz.draw(lambda plots: draw_deeponet_heldout(out_dir, plots),
                                   _plots_command(cfg.name, args.out)),
                  "wall_s": round(time.time() - t0, 1)}, seconds, launches, dev))


def saved_figures(cfg, dev, out_dir):
    """`--plots`: draw_fn(plots) of `cfg`'s branch, drawing from what its
    run saved in `out_dir`."""
    from gpe_tpu_torch.io import load_bundle

    if cfg.algorithm in ("plpinn", "beta_sweep"):
        bundles = {"bundle": load_bundle(viz.saved(os.path.join(out_dir, "bundle.pkl")))}
    elif cfg.algorithm == "cross_potential":
        bundles = {label: load_bundle(viz.saved(os.path.join(out_dir, f"{label}_bundle.pkl")))
                   for label in cross_potential_families(cfg.spec)}
    elif cfg.algorithm == "optimizer_sweep":
        return lambda plots: draw_optimizer_comparison(out_dir, plots)
    elif cfg.algorithm == "deeponet":
        return lambda plots: draw_deeponet_heldout(out_dir, plots)
    else:
        raise ValueError(f"experiment {cfg.name!r} ({cfg.algorithm}) draws no figure")
    return bundle_figures(cfg, bundles, out_dir, dev)


BRANCHES = ("plpinn", "fit", "cross_potential", "compare", "two_stage", "beta_sweep",
            "p_ramp", "deflation", "relobralo", "optimizer_sweep", "helmholtz",
            "deeponet")


def main(argv=None):
    ap = argparse.ArgumentParser(description="gpe_tpu_torch experiment runner")
    ap.add_argument("name", help="experiment name (see --list)")
    ap.add_argument("--list", action="store_true", help="list experiments and exit")
    ap.add_argument("--train", action="store_true", help="force fresh training")
    ap.add_argument("--out", default="runs_torch", help="output directory")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--modes", type=int, nargs="*", default=None)
    ap.add_argument("--gammas", type=float, nargs="*", default=None)
    ap.add_argument("--betas", type=float, nargs="*", default=None)
    ap.add_argument("--pretrain", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--lm-steps", type=int, default=None,
                    help="LM polish steps of an lm_polish or helmholtz config "
                         "(default 120) or of each deflated state (default 60)")
    ap.add_argument("--lbfgs-steps", type=int, default=None,
                    help="helmholtz: L-BFGS steps after Adam (default 100)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--plots", action="store_true",
                    help="draw the figures from the saved bundle(s) or .npz files of "
                         "<out>/<name>; train nothing")
    args = ap.parse_args(argv)

    from gpe_tpu_torch.experiments.configs import EXPERIMENTS, WAITING

    if args.name == "list" or args.list:
        for k, v in EXPERIMENTS.items():
            print(f"{k:32s} algo={v.algorithm:10s} modes={v.modes} "
                  f"γ∈[{v.gamma_values[0]:g},{v.gamma_values[-1]:g}]×{len(v.gamma_values)}")
        return 0
    if args.name in WAITING:
        raise NotImplementedError(
            f"experiment {args.name!r} waits for {WAITING[args.name]}, not ported yet")
    if args.name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {args.name!r}; have {sorted(EXPERIMENTS)}")

    from gpe_tpu_torch.device import resolve_device

    cfg = EXPERIMENTS[args.name]
    for field, value in (("epochs", args.epochs), ("pretrain_epochs", args.pretrain),
                         ("seed", args.seed)):
        if value is not None:
            cfg = dataclasses.replace(cfg, **{field: value})
    if args.modes is not None:
        cfg = dataclasses.replace(cfg, modes=tuple(args.modes))
    if args.gammas is not None:
        cfg = dataclasses.replace(cfg, gamma_values=tuple(args.gammas))
    if args.betas is not None:
        cfg = dataclasses.replace(cfg, beta_values=tuple(args.betas))
    if cfg.algorithm not in BRANCHES:
        raise NotImplementedError(f"algorithm {cfg.algorithm!r} is not ported yet; "
                                  "see gpe_tpu.experiments.run")
    dev = resolve_device("cpu" if args.cpu else None)
    out_dir = os.path.join(args.out, cfg.name)
    if args.plots:
        viz.draw_saved(saved_figures(cfg, dev, out_dir), experiment=cfg.name)
        return 0
    mesh = _mesh(args.cpu) if cfg.use_mesh else None
    if mesh is not None:
        dev = mesh.device
    lead = mesh is None or mesh.rank == 0

    os.makedirs(out_dir, exist_ok=True)
    records = []

    def emit(record):
        if lead:
            print(json.dumps(record, default=str), flush=True)
            records.append(record)

    if cfg.algorithm == "plpinn":
        _run_plpinn(cfg, args, dev, out_dir, emit, mesh)
    elif cfg.algorithm == "fit":
        _run_fit(cfg, dev, emit)
    elif cfg.algorithm == "compare":
        _run_compare(cfg, dev, out_dir, emit)
    elif cfg.algorithm == "cross_potential":
        _run_cross_potential(cfg, args, dev, out_dir, emit)
    elif cfg.algorithm == "two_stage":
        _run_two_stage(cfg, dev, emit)
    elif cfg.algorithm == "beta_sweep":
        _run_beta_sweep(cfg, args, dev, out_dir, emit)
    elif cfg.algorithm == "p_ramp":
        _run_p_ramp(cfg, dev, emit)
    elif cfg.algorithm == "deflation":
        _run_deflation(cfg, args, dev, emit)
    elif cfg.algorithm == "optimizer_sweep":
        _run_optimizer_sweep(cfg, args, dev, out_dir, emit)
    elif cfg.algorithm == "helmholtz":
        _run_helmholtz(cfg, args, dev, emit)
    elif cfg.algorithm == "deeponet":
        _run_deeponet(cfg, args, dev, out_dir, emit)
    else:
        _run_relobralo(cfg, dev, emit)
    if lead:
        _write_summary(out_dir, records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
