"""Ensemble training on the run axis of the fused kernels, port of
`gpe_tpu/train/packed.py` (lane-packed ensembles).

The JAX package trains an ensemble of R width-w nets as R // M lane-packed
units (M = 128 // w runs per TPU kernel, block-masked gradients). The port
keeps the ensemble run-stacked — a leading run axis R on every leaf — and
advances all R runs with ONE launch of each run-mode kernel per step
(`kernels/fused_grad.py`, runs=True); M (`_pick_m`) still decides which
ensembles take this path, exactly as in JAX.

Per-run semantics kept from the JAX package:
- per-run early stop (tol/patience), best-loss state restored per run, μ of
  the best state evaluated at the restored params;
- per-run gradient clipping and per-run LR (`packed_ramp_optimizer`);
- frozen (done) runs keep their params bit-frozen; their optimizer MOMENTS
  keep evolving (their updates are discarded at the params level), as in
  the JAX packed path — unobservable in any output.

The carry stays on the device; the host reads the loss/μ histories and the
done flags once per `check_every` chunk, and decides there whether the whole
ensemble is done.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple

import numpy as np
import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.kernels.fused_residual import make_loss_eval
from gpe_tpu_torch.kernels.packing import packable_runs
from gpe_tpu_torch.train.loop import (EnsembleFitResult, _all_done, _gathered,
                                      _run_vector, _run_where)
from gpe_tpu_torch.train.optimizers import ClipAdam
from gpe_tpu_torch.train.problem import (make_packed_value_and_grad,
                                         packed_eligible, packed_value_and_grad)
from gpe_tpu_torch.train.schedules import cosine_warm_restarts

LR_MODES = ("loss_faithful", "cosine", "constant")


def packed_ramp_optimizer(lr: float, lr_mode: str, clip_norm: float = 1.0) -> ClipAdam:
    """Per-run twin of plpinn.ramp_optimizer (and, for lr_mode="cosine", of
    clip_by_global_norm(1) + adam(cosine_warm_restarts(lr, 200, 2, 1e-6)))
    for run-stacked ensembles: per-run clip → Adam → per-run LR, where
    "loss_faithful" evaluates the warm-restart schedule at each run's loss,
    "cosine" at the step count and "constant" uses lr. `update`'s value is
    the (R,) per-run loss vector."""
    if lr_mode not in LR_MODES:
        raise ValueError(f"unknown lr_mode {lr_mode!r}; have {LR_MODES}")
    sched = cosine_warm_restarts(lr, T_0=200, T_mult=2, eta_min=1e-6)
    if lr_mode == "loss_faithful":
        return ClipAdam(lambda loss: -sched(loss), clip=clip_norm, per_run=True)
    if lr_mode == "cosine":
        return ClipAdam(clip=clip_norm, count_scale=lambda c: -sched(c), per_run=True)
    return ClipAdam(clip=clip_norm, count_scale=lambda c: -lr, per_run=True)


class PackedCarry(NamedTuple):
    params: Any                 # run-stacked params (leading axis R)
    opt_state: Any
    best_params: Any
    best_loss: torch.Tensor     # (R,)
    since_improve: torch.Tensor  # (R,)
    done: torch.Tensor          # (R,) bool
    stop_epoch: torch.Tensor    # (R,)
    epoch: int                  # steps taken (host)
    vag_state: Any = None


def _pick_m(layers, n_ensemble: int) -> int:
    """Largest run count per TPU kernel: a divisor of the ensemble size no
    bigger than what the lane budget fits."""
    cap = packable_runs(layers)
    for m in range(min(cap, n_ensemble), 1, -1):
        if n_ensemble % m == 0:
            return m
    return 1


def packed_runs_available(spec, n_ensemble: int, device=None) -> int | None:
    """M when the packed fused path applies to this spec/ensemble on
    `device` (None → the CUDA card), else None: a packable architecture, a
    divisible run count and `make_packed_value_and_grad`'s gates (None off
    the card). GPE_TPU_TORCH_NO_PACKED=1 disables it."""
    if os.environ.get("GPE_TPU_TORCH_NO_PACKED"):
        return None
    M = _pick_m(spec.layers, n_ensemble)
    if M < 2:
        return None
    return M if make_packed_value_and_grad(spec, M, device=device) is not None else None


def _ensemble_vag(spec, M: int, device: torch.device):
    """The run-mode fused gradient: the kernels through the card's gate, or
    their plain versions for CPU tensors (the JAX interpret mode's twin)."""
    if device.type == "cuda":
        vag = make_packed_value_and_grad(spec, M, device=device)
    else:
        vag = packed_value_and_grad(spec) if packed_eligible(spec, M) else None
    if vag is None:
        raise ValueError("spec not eligible for the packed fused path "
                         f"(M={M}, layers={spec.layers})")
    return vag


def fit_ensemble_packed(spec, params_batch, batch, gamma, scale,
                        epochs: int = 5001, tol: float = 1e-5,
                        patience: int = 2000, check_every: int = 512,
                        lr: float = 1e-3, lr_mode: str = "cosine",
                        clip_norm: float = 1.0, per_run_base: dict = None,
                        mesh=None) -> EnsembleFitResult:
    """Train R run-stacked nets (every leaf (R, ...)) with the run-mode fused
    kernels, on the device of `batch`; the fit_ensemble result contract. The
    optimizer is built here (packed_ramp_optimizer) — pass lr/lr_mode.

    gamma, scale: numbers or (R,) per run. per_run_base: optional
    {"base_val"/"base_lap": (R, n), "base_bval": (R, B)} giving each run its
    own perturbation base (the packed multi-mode continuation); keys present
    here override the shared `batch` entries.

    mesh (an "ens" mesh of parallel/mesh.py) shards the R // M packed units
    — each rank's R/P runs, consecutive as the units are — with no
    collective a step, as `fit_ensemble(mesh=)` shards its runs; the unit
    count must divide over the mesh, as in the JAX package."""
    pin_full_f32()
    dev = batch["x"].device
    R = params_batch[0][0].shape[0]
    M = _pick_m(spec.layers, R)
    vag = _ensemble_vag(spec, M, dev)
    stateful = bool(getattr(vag, "stateful", False))
    opt = packed_ramp_optimizer(lr, lr_mode, clip_norm)
    gamma = _run_vector(gamma, R, dev)
    scale = _run_vector(scale, R, dev)
    runb = {}
    for k, arr in (per_run_base or {}).items():
        a = torch.as_tensor(arr, dtype=torch.float32).to(dev).contiguous()
        if a.ndim != 2 or a.shape[0] != R:
            raise ValueError(f"per_run_base[{k!r}] must be (R={R}, …), "
                             f"got {tuple(a.shape)}")
        runb[k] = a
    if mesh is not None:
        from gpe_tpu_torch.parallel.mesh import shard_ensemble
        if (R // M) % mesh.size:
            raise ValueError(f"packed unit count {R // M} must divide over the "
                             f"{mesh.size}-rank mesh")
        params_batch, gamma, scale, runb = shard_ensemble(
            (params_batch, gamma, scale, runb), mesh)
        R = R // mesh.size
    b = {**batch, **runb}
    check_every = min(check_every, epochs)

    c = PackedCarry(
        params=params_batch, opt_state=opt.init(params_batch),
        best_params=params_batch,
        best_loss=torch.full((R,), float("inf"), dtype=torch.float32, device=dev),
        since_improve=torch.zeros((R,), dtype=torch.int64, device=dev),
        done=torch.zeros((R,), dtype=torch.bool, device=dev),
        stop_epoch=torch.full((R,), epochs, dtype=torch.int64, device=dev),
        epoch=0,
        vag_state=vag.init_state(params_batch, b, gamma, scale) if stateful else None)

    def step(c: PackedCarry):
        if stateful:
            (loss, aux), grads, vstate = vag(c.params, b, gamma, scale, c.vag_state)
        else:
            (loss, aux), grads = vag(c.params, b, gamma, scale)
            vstate = c.vag_state
        updates, opt_state = opt.update(grads, c.opt_state, loss)
        new_params = tuple((w + uw, bb + ub)
                           for (w, bb), (uw, ub) in zip(c.params, updates))
        keep = c.done
        improved = (loss < c.best_loss) & ~keep
        since = torch.where(improved, torch.zeros_like(c.since_improve),
                            c.since_improve + 1)
        now_done = (loss <= tol) | (since >= patience)
        stop = torch.where(keep | ~now_done, c.stop_epoch,
                           torch.full_like(c.stop_epoch, c.epoch))
        return PackedCarry(
            params=_run_where(keep, c.params, new_params),
            opt_state=opt_state,
            best_params=_run_where(improved, c.params, c.best_params),
            best_loss=torch.where(improved, loss, c.best_loss),
            since_improve=since, done=keep | now_done, stop_epoch=stop,
            epoch=c.epoch + 1, vag_state=vstate), loss, aux["mu"]

    losses, mus = [], []
    while c.epoch < epochs:
        n = min(check_every, epochs - c.epoch)
        l_hist, mu_hist = [], []
        for _ in range(n):
            c, loss, mu = step(c)
            l_hist.append(loss)
            mu_hist.append(mu)
        # one host read per chunk: (n, R) losses, (n, R) μ, the done flags
        host = torch.cat([torch.stack(l_hist), torch.stack(mu_hist),
                          c.done[None].float()]).cpu().numpy()
        losses.append(host[:n].T)
        mus.append(host[n:2 * n].T)
        if _all_done(host[-1].all(), mesh):
            break

    loss_history = np.concatenate(losses, axis=1)
    mu_history = np.concatenate(mus, axis=1)
    stop = c.stop_epoch.cpu().numpy()
    done = c.done.cpu().numpy()
    epochs_run = np.where(done, np.minimum(stop, epochs), c.epoch)
    ev = make_loss_eval(spec.layers, spec.activation, spec.p, spec.kinetic,
                        spec.nonlinearity, bc_weight=spec.bc_weight,
                        norm_weight=spec.norm_weight, runs=True)
    with torch.no_grad():
        _, aux_best = ev(c.best_params, b, gamma, scale)
    return _gathered(EnsembleFitResult(
        params=c.best_params, final_params=c.params,
        best_loss=c.best_loss.cpu().numpy(),
        mu=mu_history[:, -1],
        epochs_run=epochs_run,
        loss_history=loss_history,
        mu_history=mu_history,
        mu_best=aux_best["mu"].cpu().numpy()), mesh)


_BASE_KEYS = ("base_val", "base_grad", "base_lap", "base_bval")


def train_plpinn_modes_packed(spec, gamma_values, modes=(0, 1), epochs: int = 5001,
                              tol: float = 0.0, patience: int = 2000,
                              perturb_const: float = 0.01, lr: float = 1e-3,
                              seed: int = 0, pretrain_epochs: int = 2000,
                              check_every: int = 512, keep_params: bool = True,
                              rebase: bool = False,
                              lr_mode: str = "loss_faithful",
                              verbose: bool = False, device=None):
    """PL-PINN continuation with ALL modes advancing together in the
    run-mode kernels, on `device` (None → the CUDA card).

    Every mode shares the collocation grid and γ ramp and differs only in
    its analytic base and q-scale — the per-run quantities the kernels
    carry. Semantics per mode match train_plpinn: pretrain → normal_const →
    q-scale, per-γ Adam ramp with the lr_mode LR, early stop (tol/patience),
    best-restore, warm start, optional incremental-base rebasing (PL-PINN-R).
    Seeds as in train_plpinn: run mi starts from seed + 1000·mi, its rebase
    after γ index gi draws from (seed + 1000·mi)·1_000_003 + gi. A mode may
    repeat (a seed ensemble): mu_table[mode] then lists the runs flattened
    in ramp order, [(γ0, run0), (γ0, run1), …, (γ1, run0), …]. Returns a
    plpinn.PLPINNResult."""
    from gpe_tpu_torch.models import mlp
    from gpe_tpu_torch.models.mlp import run_slice, stack_runs
    from gpe_tpu_torch.train.plpinn import PLPINNResult, _generator, _rebase
    from gpe_tpu_torch.train.pretrain import pretrain_to_base
    from gpe_tpu_torch.train.problem import make_batch

    dev = resolve_device(device)
    pin_full_f32()
    gamma_values = [float(g) for g in gamma_values]
    gamma_values = sorted(gamma_values,
                          reverse=all(g <= 0 for g in gamma_values)
                          and any(g < 0 for g in gamma_values))
    batch = make_batch(spec, modes[0], device=dev)
    shared = {k: v for k, v in batch.items() if k not in _BASE_KEYS}

    # per-mode bases, pretrains, q-scales (one-time)
    prb = {"base_val": [], "base_lap": [], "base_bval": []}
    params_list, scales, consts = [], [], []
    for mi, mode in enumerate(modes):
        bm = make_batch(spec, mode, device=dev)
        for k in prb:
            prb[k].append(bm[k])
        p = mlp.init_mlp(spec.layers, "xavier_uniform",
                         generator=_generator(seed + 1000 * mi), dtype=spec.dtype,
                         device=dev)
        p, _ = pretrain_to_base(p, batch["x"], bm["base_val"], spec.activation,
                                epochs=pretrain_epochs, lr=1e-3)
        with torch.no_grad():
            const = float(torch.max(mlp.mlp_apply(p, batch["x"], spec.activation)))
        consts.append(const)
        scales.append(perturb_const / const)
        params_list.append(p)
    params_batch = stack_runs(params_list)
    scale_vec = torch.tensor(scales, dtype=torch.float32, device=dev)
    prb = {k: torch.stack(v) for k, v in prb.items()}

    mus = {m: [] for m in modes}
    by_gamma_params = {m: {} for m in modes}
    by_gamma_hist = {m: {} for m in modes}
    by_gamma_epochs = {m: {} for m in modes}
    for gi, gamma in enumerate(gamma_values):
        ens = fit_ensemble_packed(spec, params_batch, shared, gamma, scale_vec,
                                  epochs=epochs, tol=tol, patience=patience,
                                  check_every=check_every, lr=lr,
                                  lr_mode=lr_mode, per_run_base=prb)
        params_batch = ens.params                          # best restored
        for r, m in enumerate(modes):
            mus[m].append((gamma, float(ens.mu_best[r])))
            if keep_params:
                by_gamma_params[m][gamma] = tuple(
                    (w.cpu().numpy(), b.cpu().numpy())
                    for w, b in run_slice(ens.params, r))
            by_gamma_hist[m][gamma] = {"loss": ens.loss_history[r],
                                       "mu": ens.mu_history[r]}
            by_gamma_epochs[m][gamma] = int(ens.epochs_run[r])
        if verbose:
            print(f"γ={gamma:g}: μ=" + " ".join(f"{float(v):.5f}"
                                               for v in ens.mu_best), flush=True)
        if rebase:
            # per-run incremental-base fold (plpinn._rebase); _rebase also
            # folds base_grad, which the kernels never read: a zero dummy
            new_p, new_b = [], {k: [] for k in prb}
            for r in range(len(modes)):
                batch_r = dict(shared, base_grad=torch.zeros_like(shared["x"]),
                               **{k: v[r] for k, v in prb.items()})
                batch_r, p_r = _rebase(
                    spec, batch_r, run_slice(params_batch, r), float(scale_vec[r]),
                    _generator((seed + 1000 * r) * 1_000_003 + gi))
                for k in new_b:
                    new_b[k].append(batch_r[k])
                new_p.append(p_r)
            prb = {k: torch.stack(v) for k, v in new_b.items()}
            params_batch = stack_runs(new_p)

    return PLPINNResult(
        params_by_mode=by_gamma_params,
        mu_table={m: mus[m] for m in modes},
        training_history=by_gamma_hist,
        constant_history={m: consts[i] for i, m in enumerate(modes)},
        epochs_history=by_gamma_epochs,
        polished={},
    )
