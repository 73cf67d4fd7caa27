"""Collocation grids, quadrature weights and reductions, port of
`gpe_tpu/ops/quadrature.py`. The reductions take an optional process
group (JAX's `axis_name`): with collocation points sharded over its ranks
they sum over all of them (`ops.collectives`)."""
from __future__ import annotations

import torch

from gpe_tpu_torch.ops.collectives import global_count, psum


def uniform_grid(lb, ub, n: int, d: int = 1, dtype=torch.float64,
                 device=None) -> torch.Tensor:
    """Uniform collocation grid on [lb, ub]^d, shape (n^d, d), with the
    first axis slowest (meshgrid indexing="ij")."""
    ax = torch.linspace(lb, ub, n, dtype=dtype, device=device)
    if d == 1:
        return ax[:, None]
    mesh = torch.meshgrid(*([ax] * d), indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1)


def trapezoid_weights(lb, ub, n: int, d: int = 1, dtype=torch.float64,
                      device=None) -> torch.Tensor:
    """Trapezoid-rule weights for `uniform_grid(lb, ub, n, d)`, shape (n^d,)."""
    h = (ub - lb) / (n - 1)
    w1 = torch.full((n,), h, dtype=dtype, device=device)
    w1[0] *= 0.5
    w1[-1] *= 0.5
    w = w1
    for _ in range(d - 1):
        w = (w[:, None] * w1[None, :]).reshape(-1)
    return w


def riemann_weights(lb, ub, n: int, d: int = 1, dtype=torch.float64,
                    device=None) -> torch.Tensor:
    """Plain Riemann weights dx^d (the reference's Σu²·dx convention)."""
    h = (ub - lb) / (n - 1)
    return torch.full((n ** d,), h ** d, dtype=dtype, device=device)


def _acc(dtype) -> torch.dtype:
    """At least float32 accumulation, whatever the element dtype."""
    return torch.promote_types(dtype, torch.float32)


def integrate(fx: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """∫f ≈ Σᵢ wᵢ f(xᵢ), accumulated in at least float32; summed over the
    ranks of `group` when the points are sharded."""
    wf = w * fx
    return psum(torch.sum(wf, dtype=_acc(wf.dtype)), group)


def wmean(fx: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the collocation points, accumulated in at least float32;
    over every rank's points (the global sum over the global count) under
    `group`."""
    return psum(torch.sum(fx, dtype=_acc(fx.dtype)), group) / global_count(
        fx.numel(), group)
