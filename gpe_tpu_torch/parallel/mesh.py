"""Collocation and ensemble data parallelism over `torch.distributed`, port
of `gpe_tpu/parallel/mesh.py`.

The JAX package drives every device of a mesh from one process under
`shard_map`; here each rank is a process of its own, joined by a process
group, that holds its shard and makes the collectives explicitly. The names
stay JAX's, so each function has its counterpart there:

- `Mesh` is the group with this rank's place in it and its device;
  `axis_names` is `("data",)` (collocation points) or `("ens",)` (runs);
  the collocation entry points (`fit`) take a "data" mesh, the ensemble
  ones (`fit_ensemble`, `fit_ensemble_packed`) an "ens" mesh, and raise
  on the other kind.
- Collocation arrays are sharded on their leading axis, rank r holding the
  contiguous rows [r·n/P, (r+1)·n/P) — the block `NamedSharding(P("data"))`
  gives device r; params and boundary points are replicated.
- Every quadrature reduction of a loss is `ops.collectives.psum`, an
  all-reduce whose
  backward all-reduces the cotangent (the transpose of `jax.lax.psum`'s
  broadcast). Autograd of a sharded loss on rank r then gives the gradient
  of the sum over ranks of their (equal) losses with respect to its own
  copy of the params; the mean of those gradients over the ranks is the
  gradient of the loss: each rank's share of the sums counts once, and so
  does the replicated boundary term (`make_parallel_value_and_grad`).
- The fused gradient (kernels/fused_grad.py) reduces its sums and weight
  gradients itself under `group=` (its psum-aware mode).
- Ensembles shard the run axis: rank r steps runs [r·R/P, (r+1)·R/P) with
  no collective per step; `gather_ensemble` puts the runs back together on
  every rank at the end of a fit.

The backend is the caller's: NCCL on the card, gloo on the CPU (and for
several ranks on one card, which NCCL refuses). Gloo has no `all_gather`
on CUDA tensors, so the gather is an all-reduce of a zero-padded buffer.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from gpe_tpu_torch.ops.collectives import psum_tree

AXIS, ENS = "data", "ens"       # the collocation and the run axis


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the process group, this rank, the group size, the axis
    name and this rank's device."""
    group: Any
    rank: int
    size: int
    axis_names: tuple
    device: torch.device


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None) -> bool:
    """Join this process to a multi-process group (`init_process_group`).

    The coordinator is `coordinator_address` ("host:port") or, where
    `torchrun` sets them, MASTER_ADDR/MASTER_PORT; the world size and rank
    are the arguments or WORLD_SIZE/RANK. backend None is NCCL; name "gloo"
    for ranks on the CPU. Returns True when a group is (or already was)
    initialized, False in a plain single-process session (no coordinator),
    as the JAX package's `initialize_multihost` does."""
    if dist.is_initialized():
        return True
    if coordinator_address is not None:
        init = f"tcp://{coordinator_address}"
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init = "env://"
    else:
        return False
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    dist.init_process_group(backend or "nccl", init_method=init,
                            world_size=world, rank=rank)
    return True


def make_mesh(n_devices: int | None = None, axis: str = AXIS, device=None,
              backend: str | None = None) -> Mesh:
    """The mesh of the initialized process group; in a plain single process
    a world-size-1 group (backend None: NCCL on the card, gloo for
    device="cpu"), as the JAX package's `make_mesh()` on one device gives a
    1-device mesh. Rank r runs on cuda:(r % device_count) unless `device`
    says otherwise. n_devices, when given, must be the group's size."""
    if device is None:
        from gpe_tpu_torch.device import resolve_device
        resolve_device()                      # raises when there is no card
    if not dist.is_initialized():
        cpu = device is not None and torch.device(device).type == "cpu"
        dist.init_process_group(backend or ("gloo" if cpu else "nccl"),
                                store=dist.HashStore(), world_size=1, rank=0)
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices needs a group of that "
                         f"size; this group has {size} ranks")
    if device is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(dist.group.WORLD, rank, size, (axis,), device)


def mean_over_ranks(tree, mesh: Mesh):
    """The mean over the ranks of each leaf (the replicated params' gradient
    of a sharded loss, as DDP averages it): one all-reduce."""
    return pytree.tree_map(lambda t: t / mesh.size, psum_tree(tree, mesh.group))


def all_ranks(flag: bool, mesh: Mesh) -> bool:
    """True when `flag` holds on every rank (a host decision every rank
    takes alike)."""
    t = torch.tensor([0 if flag else 1], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return int(t) == 0


def batch_pspecs(batch: dict) -> dict:
    """The placement of each batch entry: "data" (sharded) for arrays whose
    leading axis is the collocation count (as long as batch["x"]), None
    (replicated) for everything else: boundary points, probe sets, scalars.
    The rule is structural, as in the JAX package."""
    n = batch["x"].shape[0]
    return {k: AXIS if getattr(v, "ndim", 0) >= 1 and v.shape[0] == n else None
            for k, v in batch.items()}


def _require(mesh: Mesh, axis: str, what: str) -> None:
    """Raise unless `mesh` is a mesh of `axis`: "data" shards collocation
    points (`fit`), "ens" runs (`fit_ensemble`, `fit_ensemble_packed`)."""
    if mesh.axis_names != (axis,):
        raise ValueError(f"{what} shards over a {axis!r} mesh; this mesh's axis is "
                         f"{mesh.axis_names[0]!r} (make_mesh(axis={axis!r}))")


def _block(n: int, mesh: Mesh, what: str, axis: str) -> slice:
    _require(mesh, axis, what)
    if n % mesh.size:
        raise ValueError(f"{what} {n} does not divide over the {mesh.size}-rank mesh")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's share of a batch on a "data" mesh: its contiguous block
    of rows of every collocation array (`batch_pspecs`), the other entries
    whole."""
    rows = _block(batch["x"].shape[0], mesh, "the collocation count", AXIS)
    specs = batch_pspecs(batch)
    return {k: v[rows].contiguous() if specs[k] is not None else v
            for k, v in batch.items()}


def make_parallel_loss(loss_fn: Callable, mesh: Mesh, batch: dict) -> Callable:
    """sharded_loss(params, b, gamma, scale) -> (total, aux) for a psum-aware
    loss_fn(params, batch, gamma, scale, group=): b is this rank's shard
    (`shard_batch(batch, mesh)`), the outputs are the global loss, the same
    on every rank."""
    _block(batch["x"].shape[0], mesh, "the collocation count", AXIS)

    def sharded(params, b, gamma, scale):
        return loss_fn(params, b, gamma, scale, group=mesh.group)

    return sharded


def make_parallel_value_and_grad(loss_fn: Callable, mesh: Mesh,
                                 batch: dict) -> Callable:
    """vag(params, b, gamma, scale) -> ((total, aux), grads): autograd of the
    sharded loss (`make_parallel_loss`), the gradients averaged over the
    ranks (module docstring) — the gradient of the global loss, the same on
    every rank. The torch form of `jax.value_and_grad` over JAX's sharded
    loss."""
    from gpe_tpu_torch.train.loop import value_and_grad

    vag = value_and_grad(make_parallel_loss(loss_fn, mesh, batch))

    def sharded(params, b, gamma, scale):
        value, grads = vag(params, b, gamma, scale)
        return value, mean_over_ranks(grads, mesh)

    return sharded


def make_parallel_vag(vag: Callable, mesh: Mesh, batch: dict) -> Callable:
    """A psum-aware value_and_grad (the fused gradient of kernels/
    fused_grad.py) on the mesh: the kernels run on this rank's shard and
    the vag reduces the global sums before the cotangents and the weight
    gradients after (its `group=` mode). Exact (stateless) and relaxed
    (stateful, `.init_state`) alike; the relaxed state holds the global
    sums, the same on every rank."""
    _block(batch["x"].shape[0], mesh, "the collocation count", AXIS)
    if getattr(vag, "stateful", False):
        def sharded(params, b, gamma, scale, state):
            return vag(params, b, gamma, scale, state, group=mesh.group)

        def init_state(params, b, gamma, scale):
            return vag.init_state(params, b, gamma, scale, group=mesh.group)

        sharded.stateful = True
        sharded.init_state = init_state
        return sharded

    def sharded(params, b, gamma, scale):
        return vag(params, b, gamma, scale, group=mesh.group)

    return sharded


# The JAX package caches these wrappers weakly on the wrapped function so
# that its jitted fit compiles once per ramp; the port's fit keys no compile
# cache on the function, so the cached forms are the builders themselves.
parallel_loss_cached = make_parallel_loss
parallel_vag_cached = make_parallel_vag


def make_parallel_step(loss_fn: Callable, optimizer, mesh: Mesh,
                       batch: dict) -> Callable:
    """step(params, opt_state, b, gamma, scale) -> (params, opt_state,
    total, aux): loss, gradient and optimizer update with the loss sharded
    (`make_parallel_value_and_grad`); `optimizer` has init(params) /
    update(grads, state, params, value=)."""
    vag = make_parallel_value_and_grad(loss_fn, mesh, batch)

    def step(params, opt_state, b, gamma, scale):
        (total, aux), grads = vag(params, b, gamma, scale)
        updates, opt_state = optimizer.update(grads, opt_state, params, value=total)
        return pytree.tree_map(torch.add, params, updates), opt_state, total, aux

    return step


def make_ensemble_step(loss_fn: Callable, optimizer, mesh: Mesh):
    """step(params_b, opt_state_b, batch, gamma, scales) -> (params_b,
    opt_state_b, total (R/P,), μ (R/P,)) over this rank's runs
    (`shard_ensemble`): autograd of the loss vmapped over them
    (torch.func), each run clipped and stepped on its own (`optimizer`'s
    `per_run_form()`, whose state `opt_state_b` is); the batch is whole on
    every rank and no collective runs. `mesh` is an "ens" mesh."""
    from torch.func import grad_and_value, vmap

    _require(mesh, ENS, "the ensemble step")
    opt = optimizer.per_run_form()
    gv = vmap(grad_and_value(loss_fn, has_aux=True), in_dims=(0, None, None, 0))

    def step(params_b, opt_state_b, batch, gamma, scales):
        grads, (total, aux) = gv(params_b, batch, gamma, scales)
        updates, opt_state_b = opt.update(grads, opt_state_b, total)
        return (pytree.tree_map(torch.add, params_b, updates), opt_state_b,
                total, aux["mu"])

    return step


def shard_ensemble(tree, mesh: Mesh):
    """This rank's runs of a tree whose leaves lead with the run axis R, on
    an "ens" mesh: the contiguous block [r·R/P, (r+1)·R/P) of every leaf."""
    leaves = pytree.tree_leaves(tree)
    rows = _block(leaves[0].shape[0], mesh, "the run count", ENS)
    return pytree.tree_map(lambda t: t[rows], tree)


def gather_ensemble(tree, mesh: Mesh):
    """The inverse of `shard_ensemble` on every rank: each leaf's blocks of
    runs put back together in rank order, by an all-reduce of a zero
    buffer holding this rank's block (gloo has no all_gather on CUDA
    tensors). Tensor leaves stay on their device; numpy leaves come back as
    numpy."""
    def gather(a):
        t = torch.as_tensor(a).to(mesh.device)
        full = t.new_zeros((t.shape[0] * mesh.size,) + tuple(t.shape[1:]))
        full[mesh.rank * t.shape[0]:(mesh.rank + 1) * t.shape[0]] = t
        dist.all_reduce(full, group=mesh.group)
        return full.cpu().numpy() if isinstance(a, np.ndarray) else full

    return pytree.tree_map(gather, tree)


def spawn(fn: Callable, nprocs: int, *args, backend: str = "gloo",
          device=None) -> None:
    """Run fn(mesh, *args) on `nprocs` ranks of a new group
    (torch.multiprocessing.spawn, a file:// store in a temporary
    directory), rank r on cuda:(r % device_count) or on `device`. `fn` must
    be importable by module path; a rank's exception is raised here. The
    ranks meet in a barrier after fn, so none tears the group down while a
    peer is still joining it or running fn. Returns with no process of its
    own left running: multiprocessing's resource tracker, which the spawn
    starts for the ranks, is stopped once they have exited (else it
    outlives this process by a moment). That
    holds too where a tracker was recorded but had died: the spawn then
    reaps it and starts a new one, which is the spawn's own. A tracker that
    was running before the call is left running."""
    import tempfile
    from multiprocessing import resource_tracker

    import torch.multiprocessing as mp

    tracker = resource_tracker._resource_tracker
    pid_before = tracker._pid
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        try:
            mp.spawn(_rank_main, args=(fn, nprocs, backend, init, device, args),
                     nprocs=nprocs, join=True)
        finally:
            if tracker._pid is not None and tracker._pid != pid_before:
                _stop_resource_tracker(tracker)


def _stop_resource_tracker(tracker) -> None:
    """Close the tracker's pipe, which ends its loop, and reap it."""
    with tracker._lock:
        if tracker._pid is not None:
            os.close(tracker._fd)
            os.waitpid(tracker._pid, 0)
            tracker._fd = tracker._pid = None


def _rank_main(rank, fn, nprocs, backend, init, device, args):
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init, world_size=nprocs, rank=rank)
    try:
        fn(make_mesh(nprocs, device=device), *args)
        # No rank closes its connections before every rank has finished
        # fn: a rank whose fn runs no collective would otherwise tear its
        # pairs down while a peer is still in gloo's connectFullMesh, which
        # then fails with "Connection closed by peer".
        dist.barrier()
    finally:
        dist.destroy_process_group()
