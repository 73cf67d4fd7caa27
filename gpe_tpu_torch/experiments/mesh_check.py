"""Rank programs of the mesh paths (parallel/mesh.py): each case runs one
sharded path on every rank of a group and returns its results as numpy,
which `run_cases` collects per rank for the caller to hold against the
unsharded path in its own process.

    from gpe_tpu_torch.experiments.mesh_check import run_cases
    ranks = run_cases([("a", "vag", dict(spec=spec, params=p, gamma=2.0,
                                         scale=0.05))], nprocs=2, device="cpu")
    ranks[0]["a/total"], ranks[1]["a/grads"], ...

The cases: `vag` (`walk` of the psum-aware fused value-and-grad, exact
or relaxed, over a few steps), `fit` (`fit(mesh=)` on the fused or the plain route),
`ensemble` (`fit_ensemble(mesh=)`), `packed` (`fit_ensemble_packed(mesh=)`),
`steps` (`make_parallel_loss`, `make_parallel_step`), `ensemble_step`
(`make_ensemble_step`),
`plpinn` (`train_plpinn(mesh=)`), `compare` (`train_single_model` and
`train_multiple_runs` with `mesh=`), `runner` (`experiments/run.py`'s
main on every rank), `sharded` (`dynamics/sharded.py:evolve_sharded`, the
grid in slabs, the port of the JAX package's dry-run stage 6) and
`all_to_all` (`ops/collectives.all_to_all` on every pair of axes) and
`teardown` (no collective: when each rank leaves the spawn).
chip_smoke.py runs them on the card at full width over gloo ranks on one
card; tests/test_torch_mesh*.py and test_torch_sharded.py on the CPU.
Every case but `all_to_all` and `teardown` records the K1/K2/K3 launches
of its rank (0 on the CPU).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch


def flat(tree) -> np.ndarray:
    """The leaves of a params tree laid end to end, as float64 numpy."""
    from torch.utils import _pytree as pytree
    return np.concatenate([np.asarray(t.detach().cpu(), np.float64).ravel()
                           for t in pytree.tree_leaves(tree)])


def _params(params, mesh):
    from gpe_tpu_torch.models.mlp import params_from_numpy
    return params_from_numpy(params, device=mesh.device)


def _batch(spec, mesh, mode: int = 0):
    from gpe_tpu_torch.train.problem import make_batch
    return make_batch(spec, mode, device=mesh.device)


def _ens(mesh):
    """The "ens" mesh of this rank's group (the ensemble entry points)."""
    from gpe_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(mesh.size, axis="ens", device=mesh.device)


def _fused_vag(spec, device, relaxed=None, n_shards: int = 1,
               refresh_every: int = 0, exact_until: int = 0, bf16: bool = False):
    """The spec's fused gradient: `make_fused_value_and_grad` on the card;
    on the CPU, which that declines, and in the bf16 operand mode (bf16),
    the same vag built directly (on the CPU the kernels' plain versions),
    with the relaxed settings it would resolve. refresh_every /
    exact_until > 0 turn on the relaxed step's exact K1 correctors."""
    from gpe_tpu_torch.kernels import fused_grad
    from gpe_tpu_torch.train.problem import _resolve_relaxed, make_fused_value_and_grad

    if device.type == "cuda" and not bf16:
        return make_fused_value_and_grad(spec, device=device, relaxed=relaxed,
                                         n_shards=n_shards, refresh_every=refresh_every,
                                         exact_until=exact_until)
    relaxed, fresh, extrap = _resolve_relaxed(relaxed, None, None)
    return fused_grad.make_value_and_grad(
        spec.layers, spec.activation, spec.p, spec.kinetic, spec.nonlinearity,
        bc_weight=spec.bc_weight, norm_weight=spec.norm_weight, delayed=relaxed,
        fresh_values=fresh, extrapolate=extrap, refresh_every=refresh_every,
        exact_until=exact_until, compute_dtype=torch.bfloat16 if bf16 else torch.float32)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches(counter) -> dict:
    return {f"launches_{k}": np.int64(v) for k, v in counter.since().items()}


def walk(vag, params, batch, gamma, scale, steps: int = 1, lr: float = 1e-3) -> dict:
    """`steps` calls of a value-and-grad, the params walked p − lr·g between
    them (as the JAX package's test walks them); a stateful (relaxed) vag
    starts from `init_state`. total, μ and the flat gradient of each step,
    the relaxed state's sums after `init_state` and after each step."""
    out = {"total": [], "mu": [], "grads": [], "state": []}
    stateful = getattr(vag, "stateful", False)
    state = vag.init_state(params, batch, gamma, scale) if stateful else None
    if stateful:
        out["state"].append(state[0].cpu().numpy())
    for _ in range(steps):
        if stateful:
            (total, aux), grads, state = vag(params, batch, gamma, scale, state)
            out["state"].append(state[0].cpu().numpy())
        else:
            (total, aux), grads = vag(params, batch, gamma, scale)
        out["total"].append(float(total))
        out["mu"].append(float(aux["mu"]))
        out["grads"].append(flat(grads))
        params = tuple((w - lr * gw, b - lr * gb)
                       for (w, b), (gw, gb) in zip(params, grads))
    return {k: np.asarray(v) for k, v in out.items() if v}


def case_vag(mesh, spec, params, gamma, scale, relaxed=False, steps: int = 1,
             refresh_every: int = 0, exact_until: int = 0, lr: float = 1e-3,
             bf16: bool = False):
    """`walk` of the psum-aware fused vag on this rank's shard
    (`make_parallel_vag`): exact (relaxed False), or relaxed (True, or None
    for the default with fresh values and extrapolation), with its exact
    K1 correctors where refresh_every / exact_until > 0 (`_fused_vag`),
    in the bf16 operand mode with bf16; the params walked with step `lr`."""
    from gpe_tpu_torch.kernels._common import LaunchCounter
    from gpe_tpu_torch.parallel.mesh import make_parallel_vag, shard_batch

    batch = _batch(spec, mesh)
    svag = make_parallel_vag(_fused_vag(spec, mesh.device, relaxed,
                                        refresh_every=refresh_every,
                                        exact_until=exact_until, bf16=bf16), mesh, batch)
    counter = LaunchCounter()
    res = walk(svag, _params(params, mesh), shard_batch(batch, mesh), gamma, scale,
               steps, lr)
    _sync(mesh.device)
    res.update(_launches(counter))
    return res


def case_fit(mesh, spec, params, gamma, scale, epochs: int, check_every: int,
             fused: bool, relaxed=None, lr: float = 1e-3, clip_norm=1.0,
             reps: int = 0):
    """`fit(mesh=)` from `params`: on the fused route (`_fused_vag` with
    n_shards = mesh.size) or the plain one; its result, seconds a step
    (host clock, synchronised) and, with reps > 0, the milliseconds of the
    collectives of one fused step: the all-reduce of the gradient and its
    sums, `reps` times, and of two sums (the fresh S₂, S₃)."""
    from gpe_tpu_torch.kernels._common import LaunchCounter
    from gpe_tpu_torch.ops.collectives import psum, psum_tree
    from gpe_tpu_torch.train.loop import fit
    from gpe_tpu_torch.train.optimizers import make_optimizer
    from gpe_tpu_torch.train.problem import make_loss_fn

    batch = _batch(spec, mesh)
    p = _params(params, mesh)
    vag = _fused_vag(spec, mesh.device, relaxed, mesh.size) if fused else None
    opt = make_optimizer("adam", lr, clip_norm=clip_norm)
    counter = LaunchCounter()
    _sync(mesh.device)
    t0 = time.perf_counter()
    r = fit(make_loss_fn(spec), opt, p, batch, gamma, scale, epochs=epochs, tol=0.0,
            patience=10 ** 9, check_every=check_every, value_and_grad_fn=vag,
            mesh=mesh)
    _sync(mesh.device)
    res = {"s": (time.perf_counter() - t0) / max(r.epochs_run, 1),
           "best_loss": r.best_loss, "mu_best": r.mu_best,
           "loss_history": r.loss_history, "mu_history": r.mu_history,
           "params": flat(r.params), "epochs_run": r.epochs_run}
    res.update(_launches(counter))
    if reps:
        grads_and_sums = (p, torch.zeros(4, device=mesh.device))
        two = torch.zeros(2, device=mesh.device)
        for name, fn in (("allreduce_grads_ms", lambda: psum_tree(grads_and_sums,
                                                                  mesh.group)),
                         ("allreduce_sums_ms", lambda: psum(two, mesh.group))):
            fn()
            _sync(mesh.device)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            _sync(mesh.device)
            res[name] = 1e3 * (time.perf_counter() - t0) / reps
    return res


def _ensemble_result(r) -> dict:
    return {"loss_history": r.loss_history, "mu_history": r.mu_history, "mu": r.mu,
            "best_loss": r.best_loss, "mu_best": r.mu_best,
            "epochs_run": r.epochs_run, "params": flat(r.params)}


def case_ensemble(mesh, spec, params_b, gamma, scales, epochs: int, check_every: int,
                  fused: bool, relaxed=False, lr: float = 1e-3):
    """`fit_ensemble(mesh=)` of the run-stacked `params_b` (Adam, clip 1.0),
    on the fused route (K3 through `vag.run_axis`) or torch.func; the
    gathered result and this rank's launches."""
    from gpe_tpu_torch.kernels._common import LaunchCounter
    from gpe_tpu_torch.train.loop import fit_ensemble
    from gpe_tpu_torch.train.optimizers import make_optimizer
    from gpe_tpu_torch.train.problem import make_loss_fn

    batch = _batch(spec, mesh)
    pb = _params(params_b, mesh)
    vag = _fused_vag(spec, mesh.device, relaxed) if fused else None
    counter = LaunchCounter(runs=True)
    t0 = time.perf_counter()
    r = fit_ensemble(make_loss_fn(spec), make_optimizer("adam", lr, clip_norm=1.0),
                     pb, batch, gamma, scales, epochs=epochs, tol=0.0,
                     patience=10 ** 9, check_every=check_every,
                     value_and_grad_fn=vag, mesh=_ens(mesh))
    res = _ensemble_result(r)
    res["s"] = time.perf_counter() - t0
    res.update(_launches(counter))
    return res


def case_packed(mesh, spec, params_b, gamma, scales, epochs: int, check_every: int,
                lr_mode: str = "cosine", tol: float = 0.0):
    """`fit_ensemble_packed(mesh=)`: the gathered result and the launches."""
    from gpe_tpu_torch.kernels._common import LaunchCounter
    from gpe_tpu_torch.train.packed import fit_ensemble_packed

    counter = LaunchCounter(runs=True)
    r = fit_ensemble_packed(spec, _params(params_b, mesh), _batch(spec, mesh), gamma,
                            scales, epochs=epochs, tol=tol, patience=10 ** 9,
                            check_every=check_every, lr_mode=lr_mode, mesh=_ens(mesh))
    res = _ensemble_result(r)
    res.update(_launches(counter))
    return res


def case_steps(mesh, spec, params, gamma, scale):
    """`make_parallel_loss` (total, μ) and one `make_parallel_step` (Adam
    1e-3, clip 1.0) from `params` on this rank's shard."""
    from gpe_tpu_torch.parallel import mesh as pm
    from gpe_tpu_torch.train.optimizers import make_optimizer
    from gpe_tpu_torch.train.problem import make_loss_fn

    loss_fn = make_loss_fn(spec)
    batch = _batch(spec, mesh)
    local = pm.shard_batch(batch, mesh)
    p = _params(params, mesh)
    with torch.no_grad():
        total, aux = pm.make_parallel_loss(loss_fn, mesh, batch)(p, local, gamma, scale)
    opt = make_optimizer("adam", 1e-3, clip_norm=1.0)
    step = pm.make_parallel_step(loss_fn, opt, mesh, batch)
    p1, _, t1, _ = step(p, opt.init(p), local, gamma, scale)
    return {"loss_total": float(total), "loss_mu": float(aux["mu"]),
            "step_total": float(t1), "step_params": flat(p1)}


def case_ensemble_step(mesh, spec, params_b, gamma, scales):
    """One `make_ensemble_step` (Adam 1e-3) of this rank's runs of
    `params_b` on an "ens" mesh of this group, gathered."""
    from gpe_tpu_torch.parallel import mesh as pm
    from gpe_tpu_torch.train.optimizers import make_optimizer
    from gpe_tpu_torch.train.problem import make_loss_fn

    emesh = _ens(mesh)
    opt = make_optimizer("adam", 1e-3)
    pb = pm.shard_ensemble(_params(params_b, mesh), emesh)
    sc = pm.shard_ensemble(torch.as_tensor(np.asarray(scales, np.float32),
                                           device=mesh.device), emesh)
    step = pm.make_ensemble_step(make_loss_fn(spec), opt, emesh)
    pb1, _, total, mu = step(pb, opt.per_run_form().init(pb), _batch(spec, mesh),
                             torch.tensor(float(gamma), device=mesh.device), sc)
    pb1, total, mu = pm.gather_ensemble((pb1, total, mu), emesh)
    return {"total": total.cpu().numpy(), "mu": mu.cpu().numpy(), "params": flat(pb1)}


def case_plpinn(mesh, spec, **kw):
    """`train_plpinn(mesh=)`: its μ table (γ, μ) and epochs per rung of
    mode 0."""
    from gpe_tpu_torch.train.plpinn import train_plpinn

    r = train_plpinn(spec, mesh=mesh, **kw)
    return {"mu_table": np.asarray(r.mu_table[0], np.float64),
            "epochs": np.asarray([r.epochs_history[0][g] for g, _ in r.mu_table[0]])}


def case_compare(mesh, spec, gamma, n_runs: int, **kw):
    """`train_single_model(mesh=)` (the points sharded) and
    `train_multiple_runs(mesh=)` on an "ens" mesh of this group (the seeds
    sharded): μ and the loss history of the one, μ per seed of the
    other."""
    from gpe_tpu_torch.train.compare import train_multiple_runs, train_single_model

    one = train_single_model(spec, gamma, mesh=mesh, **kw)
    many = train_multiple_runs(spec, gamma, n_runs=n_runs, mesh=_ens(mesh), **kw)
    return {"single_mu": one.mu, "single_loss_history": one.loss_history,
            "multi_mu_runs": many["mu_runs"], "multi_epochs": many["epochs_run"]}


def case_runner(mesh, argv):
    """`experiments/run.py`'s main(argv) on this rank (its mesh is this
    group): its return code."""
    from gpe_tpu_torch.experiments import run
    return {"rc": np.int64(run.main(list(argv)))}


def reversed_all_to_all(t, split_axis, concat_axis, group):
    """A planted fault of the sharded propagator's transpose: the received
    tiles concatenated in reverse rank order."""
    from gpe_tpu_torch.ops.collectives import all_to_all

    size = torch.distributed.get_world_size(group)
    out = all_to_all(t, split_axis, concat_axis, group)
    return torch.cat(torch.chunk(out, size, dim=concat_axis)[::-1], dim=concat_axis)


def case_sharded(mesh, psi0, V, dx, reps: int = 0, fault: bool = False,
                 ranks: int = 0, **kw):
    """`evolve_sharded(psi0, V, dx, mesh=, **kw)` on this rank's slab: the
    final ψ gathered (`sharded.gather`) and the observables (keys "obs_*").
    ranks > 0 runs it on a group of the first `ranks` ranks, which every
    rank joins in creating; the others return {}. fault=True runs it with
    `reversed_all_to_all` as its transpose. With
    reps > 0, milliseconds a step of a `reps`-step run (host clock,
    synchronised, after one such run) and of the step's two all-to-alls
    alone (`a2a_ms`: ψ's slab there and back, `reps` times). The rank's
    kernel launches (none: the path runs no kernel of csrc/)."""
    from gpe_tpu_torch.dynamics import sharded
    from gpe_tpu_torch.kernels._common import LaunchCounter
    from gpe_tpu_torch.ops.collectives import all_to_all

    if ranks:
        group = torch.distributed.new_group(list(range(ranks)))
        if mesh.rank >= ranks:
            return {}
        mesh = dataclasses.replace(mesh, group=group, size=ranks)
    counter = LaunchCounter(runs=True)
    a2a = sharded.all_to_all
    sharded.all_to_all = reversed_all_to_all if fault else a2a
    try:
        psi, obs = sharded.evolve_sharded(psi0, V, dx, mesh=mesh, **kw)
        res = {"psi": sharded.gather(psi, mesh).cpu().numpy(),
               **{f"obs_{k}": v for k, v in obs.items()}}
        if reps:
            timed = dict(kw, steps=reps, record_every=reps)
            for _ in range(2):
                torch.distributed.barrier(mesh.group)
                _sync(mesh.device)
                t0 = time.perf_counter()
                sharded.evolve_sharded(psi0, V, dx, mesh=mesh, **timed)
                _sync(mesh.device)
                res["step_ms"] = 1e3 * (time.perf_counter() - t0) / reps
            for _ in range(2):
                torch.distributed.barrier(mesh.group)
                _sync(mesh.device)
                t0 = time.perf_counter()
                for _ in range(reps):
                    all_to_all(all_to_all(psi, 1, 0, mesh.group), 0, 1, mesh.group)
                _sync(mesh.device)
                res["a2a_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    finally:
        sharded.all_to_all = a2a
    res.update(_launches(counter))
    return res


def case_all_to_all(mesh, shape, seed: int = 0):
    """`all_to_all` of this rank's block (complex128 and float32 from numpy
    at seed + rank) for every (split, concat) pair of axes: keys
    "<dtype>_<split><concat>"."""
    from gpe_tpu_torch.ops.collectives import all_to_all

    rng = np.random.default_rng(seed + mesh.rank)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    res = {}
    for name, block in (("c128", z), ("f32", z.real.astype(np.float32))):
        t = torch.as_tensor(block, device=mesh.device)
        for split in range(len(shape)):
            for concat in range(len(shape)):
                res[f"{name}_{split}{concat}"] = all_to_all(
                    t, split, concat, mesh.group).cpu().numpy()
    return res


def case_teardown(mesh, delays, log: str):
    """No collective: sleep this rank's `delays[rank]` s, then make the
    spawn's `destroy_process_group` write its clock to `<log>/destroy<rank>`,
    so the caller sees when each rank tore the group down against when the
    slowest returned ("returned")."""
    import torch.distributed as dist

    time.sleep(delays[mesh.rank])
    destroy = dist.destroy_process_group

    def logged(*a, **kw):
        with open(os.path.join(log, f"destroy{mesh.rank}"), "w") as f:
            f.write(repr(time.time()))
        return destroy(*a, **kw)

    dist.destroy_process_group = logged
    return {"rank": mesh.rank, "size": mesh.size, "returned": time.time()}


CASES = {"vag": case_vag, "fit": case_fit, "ensemble": case_ensemble,
         "packed": case_packed, "steps": case_steps,
         "ensemble_step": case_ensemble_step, "plpinn": case_plpinn,
         "compare": case_compare, "runner": case_runner, "sharded": case_sharded,
         "all_to_all": case_all_to_all, "teardown": case_teardown}


def _rank_cases(mesh, cases, out: str):
    res = {}
    for label, case, kw in cases:
        for k, v in (CASES[case] if isinstance(case, str) else case)(mesh, **kw).items():
            res[f"{label}/{k}"] = np.asarray(v)
    np.savez(os.path.join(out, f"rank{mesh.rank}.npz"), **res)


def run_cases(cases, nprocs: int = 2, backend: str = "gloo", device=None) -> list:
    """Run (label, case, kwargs) triples in order on `nprocs` new ranks
    (`parallel.mesh.spawn`; rank r on cuda:(r % device_count) or `device`);
    a case is a name of CASES or a module-level function of the same
    form. Per rank, {"<label>/<key>": numpy value}."""
    from gpe_tpu_torch.parallel.mesh import spawn

    with tempfile.TemporaryDirectory() as d:
        spawn(_rank_cases, nprocs, list(cases), d, backend=backend, device=device)
        out = []
        for r in range(nprocs):
            with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                out.append({k: z[k] for k in z.files})
        return out
