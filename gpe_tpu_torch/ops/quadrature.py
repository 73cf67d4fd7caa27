"""Collocation grids and quadrature weights, port of `gpe_tpu/ops/quadrature.py`."""
from __future__ import annotations

import torch


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
