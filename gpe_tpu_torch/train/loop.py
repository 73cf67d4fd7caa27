"""Training loops with the reference's early-stop semantics, port of
`gpe_tpu/train/loop.py` (`fit`, `fit_ensemble`).

- a gradient step each epoch (scheduler inside the optimizer);
- the best-loss params are tracked and RESTORED at the end;
- early stop when the total loss ≤ tol or no improvement for `patience`.

Everything the loop carries — params, optimizer state, best params, best
loss, patience counter, done flag, stop epoch — stays on the device. The
host reads the done flag and the loss/μ histories once per `check_every`
chunk, never per step; steps after an early stop inside a chunk are masked
(computed, not applied), as in the JAX scan. Params are any tree of tensors
(the MLP's (W, b) pairs, or the self-adaptive {"net", "log_alpha"}).

`fit_ensemble` trains R runs at once (a leading run axis on every leaf)
with the same semantics per run, where the JAX package vmaps `fit`'s chunk
over the runs: per-run γ, scale and batch entries, per-run clip and LR
(the optimizer's `per_run_form()`), early stop and best-restore. A fused
value-and-grad steps all runs in one launch of its run-mode kernels
(`vag.run_axis`); without one, `torch.func.vmap` batches autograd of the
loss over the runs.

`mesh=` (parallel/mesh.py) is the JAX package's data parallelism over
`torch.distributed`: `fit` shards the collocation points over the ranks,
`fit_ensemble` the runs. Every rank returns the same result.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from gpe_tpu_torch.device import pin_full_f32


class FitResult(NamedTuple):
    params: Any                # best params (restored)
    final_params: Any          # last-iterate params (for warm starts)
    best_loss: float
    mu: float                  # μ at the final recorded epoch
    epochs_run: int
    loss_history: np.ndarray
    mu_history: np.ndarray
    mu_best: float = 0.0       # μ evaluated at the restored best params


class EnsembleFitResult(NamedTuple):
    params: Any                # best params, leading axis = run
    final_params: Any
    best_loss: np.ndarray      # (R,)
    mu: np.ndarray             # (R,) μ at last epoch
    epochs_run: np.ndarray     # (R,)
    loss_history: np.ndarray   # (R, T)
    mu_history: np.ndarray     # (R, T)
    mu_best: np.ndarray = None  # (R,) μ at the restored best params


def value_and_grad(loss_fn: Callable) -> Callable:
    """vag(params, batch, gamma, scale) -> ((total, aux), grads) by autograd
    — the twin of jax.value_and_grad(loss_fn, has_aux=True); params is any
    tree of tensors, grads has its structure."""
    def vag(params, batch, gamma, scale):
        leaves, spec = pytree.tree_flatten(params)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            total, aux = loss_fn(pytree.tree_unflatten(leaves, spec), batch,
                                 gamma, scale)
            grads = torch.autograd.grad(total, leaves)
        aux = {k: v.detach() for k, v in aux.items()}
        return (total.detach(), aux), pytree.tree_unflatten(list(grads), spec)
    return vag


def _where(cond, a, b):
    return pytree.tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def _run_where(cond, a, b):
    """Per run: `a`'s leaves where cond (R,) else `b`'s."""
    return pytree.tree_map(
        lambda x, y: torch.where(cond.reshape(-1, *([1] * (x.ndim - 1))), x, y), a, b)


def _as_device_f32(v, device, scalar: bool = True) -> torch.Tensor:
    """v rounded to f32 on `device`: a 0-dim tensor when `scalar` or when v
    holds one number, else the f32 array as given (the two-stage trainer's
    (β, γ) pair, which its own loss unpacks; the fused kernels take a
    scalar γ)."""
    t = torch.as_tensor(v, dtype=torch.float32).to(device)
    return t.reshape(()) if scalar or t.numel() == 1 else t


def fit(loss_fn: Callable, optimizer, params, batch, gamma, scale,
        epochs: int = 5001, tol: float = 1e-5, patience: int = 2000,
        check_every: int = 512, value_and_grad_fn: Callable = None,
        mesh=None, scale_schedule: Callable = None) -> FitResult:
    """Train until convergence or `epochs`, reference early-stop semantics.

    loss_fn(params, batch, gamma, scale) -> (total, aux with 'mu'); gamma
    is rounded to f32 and reaches it as a scalar tensor or, without a fused
    gradient, as the f32 array it was given (`_as_device_f32`).
    `value_and_grad_fn` (the contract of `value_and_grad(loss_fn)`) swaps in
    a custom gradient, e.g. the fused CUDA kernels; a stateful one
    (`.stateful`, `.init_state`) is initialised here and threaded through
    the steps. `optimizer` has the protocol of train/optimizers.py:
    init(params) / update(grads, state, params, value=, obj_fn=,
    generator=); each step hands it the loss, the objective closure
    obj_fn(p) = loss_fn(p, batch, gamma, s)[0] (Hutchinson's probes, the
    L-BFGS line search) and one CPU torch.Generator (seed 0) per fit for
    the probes. `scale_schedule(epoch) -> scale` (a host number) replaces
    `scale` step by step (the curriculum's α schedule; the values of a
    chunk reach the device once a chunk), in the stateful vag's initial
    state (epoch 0) and in the best-params read-back (epoch `epochs_run`).

    `mesh` (a "data" mesh of parallel/mesh.py) shards the collocation
    points over its ranks: `batch` is the global batch, each rank keeps its
    block of rows (`shard_batch`), and the loss — the best-params read-back too —
    runs with its sums over every rank (loss_fn must take `group=`, as
    `make_loss_fn`'s does); params are replicated and every rank returns
    the same result. A custom gradient must be psum-aware (`.psum_aware`:
    the fused vags of `make_fused_value_and_grad`, built with
    n_shards=mesh.size); it then runs its kernels on the local shard with
    its own collectives. Without one, autograd of the sharded loss with the
    gradients averaged over the ranks
    (`parallel.mesh.make_parallel_value_and_grad`)."""
    pin_full_f32()
    dev = batch["x"].device
    gamma = _as_device_f32(gamma, dev, scalar=value_and_grad_fn is not None)
    scale = _as_device_f32(scale, dev)
    check_every = min(check_every, epochs)
    if mesh is not None:
        from gpe_tpu_torch.parallel.mesh import (make_parallel_value_and_grad,
                                                 parallel_loss_cached,
                                                 parallel_vag_cached, shard_batch)
        if value_and_grad_fn is None:
            value_and_grad_fn = make_parallel_value_and_grad(loss_fn, mesh, batch)
        elif getattr(value_and_grad_fn, "psum_aware", False):
            value_and_grad_fn = parallel_vag_cached(value_and_grad_fn, mesh, batch)
        else:
            raise ValueError("mesh requires a psum-aware value_and_grad_fn (the "
                             "fused vags are; build it with make_fused_value_and_"
                             "grad(spec, n_shards=mesh.size))")
        loss_fn = parallel_loss_cached(loss_fn, mesh, batch)
        batch = shard_batch(batch, mesh)
    vag = value_and_grad_fn or value_and_grad(loss_fn)
    stateful = bool(getattr(vag, "stateful", False))
    scale_at = (lambda epoch: scale) if scale_schedule is None \
        else (lambda epoch: _as_device_f32(scale_schedule(epoch), dev))
    vstate = vag.init_state(params, batch, gamma, scale_at(0)) if stateful else None
    generator = torch.Generator().manual_seed(0)

    opt_state = optimizer.init(params)
    best_params = params
    best_loss = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    since = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    stop_epoch = torch.full((), epochs, dtype=torch.int64, device=dev)

    losses, mus = [], []
    steps_done = 0
    while steps_done < epochs:
        n = min(check_every, epochs - steps_done)
        l_hist, mu_hist = [], []
        scales = None if scale_schedule is None else torch.as_tensor(np.asarray(
            [scale_schedule(steps_done + i) for i in range(n)], np.float32)).to(dev)
        for i in range(n):
            s = scale if scales is None else scales[i]
            if stateful:
                (loss, aux), grads, vstate = vag(params, batch, gamma, s, vstate)
            else:
                (loss, aux), grads = vag(params, batch, gamma, s)
            updates, opt_state = optimizer.update(
                grads, opt_state, params, value=loss, generator=generator,
                obj_fn=lambda p, s=s: loss_fn(p, batch, gamma, s)[0])
            new_params = pytree.tree_map(torch.add, params, updates)
            improved = (loss < best_loss) & ~done
            best_loss = torch.where(improved, loss, best_loss)
            best_params = _where(improved, params, best_params)
            since = torch.where(improved, torch.zeros_like(since), since + 1)
            now_done = (loss <= tol) | (since >= patience)
            stop_epoch = torch.where(done | ~now_done, stop_epoch,
                                     torch.full_like(stop_epoch, steps_done + i))
            params = _where(done, params, new_params)
            done = done | now_done
            l_hist.append(loss)
            mu_hist.append(aux["mu"])
        losses.append(torch.stack(l_hist).cpu().numpy())
        mus.append(torch.stack(mu_hist).cpu().numpy())
        steps_done += n
        if bool(done):
            break

    loss_history = np.concatenate(losses) if losses else np.zeros((0,))
    mu_history = np.concatenate(mus) if mus else np.zeros((0,))
    epochs_run = min(int(stop_epoch), epochs) if bool(done) else steps_done
    loss_history = loss_history[: max(epochs_run, 1)]
    mu_history = mu_history[: max(epochs_run, 1)]
    with torch.no_grad():
        _, aux_best = loss_fn(best_params, batch, gamma, scale_at(epochs_run))
    return FitResult(
        params=best_params,
        final_params=params,
        best_loss=float(best_loss),
        mu=float(mu_history[-1]) if mu_history.size else 0.0,
        epochs_run=epochs_run,
        loss_history=loss_history,
        mu_history=mu_history,
        mu_best=float(aux_best["mu"]),
    )


def _run_vector(v, R: int, device) -> torch.Tensor:
    """A number or an (R,) sequence as an (R,) f32 tensor on `device`."""
    t = torch.as_tensor(v, dtype=torch.float32).to(device)
    return t.expand(R).contiguous() if t.ndim == 0 else t.reshape(R).contiguous()


def _plain_ensemble(loss_fn: Callable):
    """(vag, loss) over the run axis by torch.func: vag(params, batch, prb,
    gamma, scale) -> ((total (R,), aux), run-stacked grads) and loss(...) ->
    (total, aux), with the per-run batch entries `prb` merged over the
    shared batch of each run."""
    from torch.func import grad_and_value, vmap

    def one(params, prb, batch, gamma, scale):
        return loss_fn(params, {**batch, **prb}, gamma, scale)

    dims = (0, 0, None, 0, 0)
    gv = vmap(grad_and_value(one, has_aux=True), in_dims=dims)
    ev = vmap(one, in_dims=dims)

    def vag(params, batch, prb, gamma, scale):
        grads, (total, aux) = gv(params, prb, batch, gamma, scale)
        return (total, aux), grads

    return vag, lambda params, batch, prb, gamma, scale: ev(params, prb, batch,
                                                           gamma, scale)


def fit_ensemble(loss_fn: Callable, optimizer, params_batch, batch, gamma, scale,
                 epochs: int = 5001, tol: float = 1e-5, patience: int = 2000,
                 check_every: int = 512, value_and_grad_fn: Callable = None,
                 mesh=None, per_run_batch: dict = None) -> EnsembleFitResult:
    """R runs in one batched step each epoch, on the device of the params:
    every leaf of `params_batch` has the leading run axis R.

    gamma, scale: numbers, or (R,) per run (per-seed q-scales, the vanilla
    baseline's per-checkpoint γ). per_run_batch: {key: (R, …)} batch entries
    that differ per run and override the shared `batch`'s (each seed's own
    rebased base). `optimizer` is a single-run optimizer (plpinn.
    ramp_optimizer, make_optimizer("adam")); each run is clipped and
    stepped on its own (`per_run_form()`, called as update(grads, state,
    loss) with the (R,) losses). Per-run early stop (the steps after a run's stop
    are computed, not applied), best-restore, `stop_epoch` and `epochs_run`;
    `mu_best` is μ of the loss at the restored params. The host reads the
    histories and done flags once per chunk and stops when every run is
    done.

    `value_and_grad_fn`: a single-run fused vag (problem.
    make_fused_value_and_grad); its run-mode twin `.run_axis` steps all runs
    in one launch of the run-mode kernels, a stateful one initialised here
    (one run-mode K1 launch). None: autograd of `loss_fn` vmapped over the
    runs (torch.func).

    `mesh` (an "ens" mesh of parallel/mesh.py) shards the run axis: each
    rank steps its R/P runs (`shard_ensemble`) on the whole batch with no
    collective a step; the ranks agree once a chunk on whether every run
    is done, and the result is gathered on every rank at the end
    (`gather_ensemble`). R must divide over the mesh."""
    pin_full_f32()
    leaves = pytree.tree_leaves(params_batch)
    dev, R = leaves[0].device, leaves[0].shape[0]
    gamma = _run_vector(gamma, R, dev)
    scale = _run_vector(scale, R, dev)
    prb = {}
    for k, v in (per_run_batch or {}).items():
        t = torch.as_tensor(v).to(dev).contiguous()
        if t.shape[0] != R:
            raise ValueError(f"per_run_batch[{k!r}] must lead with R={R}, "
                             f"got {tuple(t.shape)}")
        prb[k] = t
    if mesh is not None:
        from gpe_tpu_torch.parallel.mesh import shard_ensemble
        params_batch, gamma, scale, prb = shard_ensemble(
            (params_batch, gamma, scale, prb), mesh)
        R = R // mesh.size
    check_every = min(check_every, epochs)
    opt = optimizer.per_run_form()
    plain_vag, plain_loss = _plain_ensemble(loss_fn)
    state = None
    if value_and_grad_fn is None:
        def vag(p, state):
            return plain_vag(p, batch, prb, gamma, scale), state
    else:
        twin = getattr(value_and_grad_fn, "run_axis", None)
        if twin is None:
            raise ValueError("value_and_grad_fn has no run-mode twin (.run_axis); "
                             "pass a fused vag of kernels/fused_grad.py or None")
        merged = {**batch, **prb}
        if getattr(twin, "stateful", False):
            state = twin.init_state(params_batch, merged, gamma, scale)

            def vag(p, state):
                value, grads, state = twin(p, merged, gamma, scale, state)
                return (value, grads), state
        else:
            def vag(p, state):
                return twin(p, merged, gamma, scale), state

    params = params_batch
    opt_state = opt.init(params)
    best_params = params
    best_loss = torch.full((R,), float("inf"), dtype=torch.float32, device=dev)
    since = torch.zeros((R,), dtype=torch.int64, device=dev)
    done = torch.zeros((R,), dtype=torch.bool, device=dev)
    stop_epoch = torch.full((R,), epochs, dtype=torch.int64, device=dev)

    losses, mus = [], []
    steps_done = 0
    while steps_done < epochs:
        n = min(check_every, epochs - steps_done)
        l_hist, mu_hist = [], []
        for i in range(n):
            ((loss, aux), grads), state = vag(params, state)
            updates, opt_state = opt.update(grads, opt_state, loss)
            new_params = pytree.tree_map(torch.add, params, updates)
            improved = (loss < best_loss) & ~done
            best_loss = torch.where(improved, loss, best_loss)
            best_params = _run_where(improved, params, best_params)
            since = torch.where(improved, torch.zeros_like(since), since + 1)
            now_done = (loss <= tol) | (since >= patience)
            stop_epoch = torch.where(done | ~now_done, stop_epoch,
                                     torch.full_like(stop_epoch, steps_done + i))
            params = _run_where(done, params, new_params)
            done = done | now_done
            l_hist.append(loss)
            mu_hist.append(aux["mu"])
        # one host read per chunk: (n, R) losses, (n, R) μ, the done flags
        host = torch.cat([torch.stack(l_hist), torch.stack(mu_hist),
                          done[None].float()]).cpu().numpy()
        losses.append(host[:n].T)
        mus.append(host[n:2 * n].T)
        steps_done += n
        if _all_done(host[-1].all(), mesh):
            break

    loss_history = np.concatenate(losses, axis=1)
    mu_history = np.concatenate(mus, axis=1)
    stop = stop_epoch.cpu().numpy()
    epochs_run = np.where(done.cpu().numpy(), np.minimum(stop, epochs), steps_done)
    with torch.no_grad():
        _, aux_best = plain_loss(best_params, batch, prb, gamma, scale)
    return _gathered(EnsembleFitResult(
        params=best_params,
        final_params=params,
        best_loss=best_loss.cpu().numpy(),
        mu=mu_history[:, -1],
        epochs_run=epochs_run,
        loss_history=loss_history,
        mu_history=mu_history,
        mu_best=aux_best["mu"].cpu().numpy()), mesh)


def _all_done(local: bool, mesh) -> bool:
    """Whether every run is done: this rank's runs, or every rank's under a
    mesh (one all-reduce a chunk, so every rank leaves the loop together)."""
    if mesh is None:
        return bool(local)
    from gpe_tpu_torch.parallel.mesh import all_ranks
    return all_ranks(bool(local), mesh)


def _gathered(res: EnsembleFitResult, mesh) -> EnsembleFitResult:
    """An ensemble result with every rank's runs (the same on every rank)."""
    if mesh is None:
        return res
    from gpe_tpu_torch.parallel.mesh import gather_ensemble
    return EnsembleFitResult(*gather_ensemble(tuple(res), mesh))
