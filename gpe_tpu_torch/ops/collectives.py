"""The collectives of sharded collocation points and grids: a
differentiable sum over the ranks of a process group (JAX's `jax.lax.psum`
over an `axis_name`), one all-reduce of a whole tree, the global point
count, and the tiled all-to-all of the sharded propagator's transposes
(`jax.lax.all_to_all(..., tiled=True)`). Every reduction of the kernels,
the ops and the losses goes through here, so they need nothing of the mesh
(parallel/mesh.py) above them. Shards are equal
(parallel/mesh.py:shard_batch), so the global count is the local one times
the group's size, with no collective."""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


class _Psum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the cotangent."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Psum.apply(grad, ctx.group), None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of `group` (the counterpart of `jax.lax.psum`), on
    every rank, differentiable; `t` itself when group is None."""
    return t if group is None else _Psum.apply(t, group)


def psum_tree(tree, group):
    """Every leaf of `tree` summed over the ranks with ONE all-reduce of the
    leaves laid end to end (not differentiable); `tree` when group is None."""
    if group is None:
        return tree
    leaves, spec = pytree.tree_flatten(tree)
    flat = torch.cat([t.reshape(-1) for t in leaves])
    dist.all_reduce(flat, group=group)
    out = [c.view_as(t) for c, t in
           zip(torch.split(flat, [t.numel() for t in leaves]), leaves)]
    return pytree.tree_unflatten(out, spec)


def global_count(n: int, group) -> int:
    """The collocation count over every rank of `group` from this rank's
    `n` (equal shards); `n` when group is None."""
    return n if group is None else n * dist.get_world_size(group)


def all_to_all(t: torch.Tensor, split_axis: int, concat_axis: int, group) -> torch.Tensor:
    """`jax.lax.all_to_all(t, axis, split_axis, concat_axis, tiled=True)`
    over the ranks of `group`: this rank's block split along `split_axis`
    into one tile a rank, tile j sent to rank j, the tiles received
    concatenated along `concat_axis` in rank order. One
    `dist.all_to_all_single` of the tiles stacked contiguously on a new
    leading axis, which NCCL takes, and gloo on CPU and CUDA tensors alike
    (not so its list form, `dist.all_to_all`)."""
    size = dist.get_world_size(group)
    if t.shape[split_axis] % size:
        raise ValueError(f"axis {split_axis} of {tuple(t.shape)} does not split into "
                         f"{size} tiles")
    send = torch.stack(torch.chunk(t, size, dim=split_axis))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)
