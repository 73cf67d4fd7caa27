"""Wavefunction ansätze, port of `gpe_tpu/models/ansatz.py`: compositions
of the network with analytic structure, derivatives by exact propagation
(no re-differentiation of the analytic factors).

- plain:         ψ = s·N(x)
- hard BC:       ψ = g(x)·s·N(x), g vanishing on the boundary (the box's
                 sine factor); Δ(gN) = g·ΔN + 2∇g·∇N + N·Δg
- perturbation:  ψ = φ_base(x) + inner(x)

Each ansatz is a pair of functions: vgl(params, x, scale) → ValGradLap of ψ,
value(params, x, scale) → ψ only.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from gpe_tpu_torch.physics.bases import ValGradLap


class Ansatz(NamedTuple):
    vgl: Callable        # (params, x, scale) -> ValGradLap of ψ
    value: Callable      # (params, x, scale) -> ψ values (N,)


def plain_ansatz(net_vgl: Callable, net_value: Callable) -> Ansatz:
    """ψ = s·N(x)."""
    def vgl(params, x, scale=1.0):
        n = net_vgl(params, x)
        return ValGradLap(scale * n.value, scale * n.grad, scale * n.lap)

    def value(params, x, scale=1.0):
        return scale * net_value(params, x)

    return Ansatz(vgl, value)


def hard_bc_ansatz(net_vgl: Callable, net_value: Callable, factor: Callable) -> Ansatz:
    """ψ = g(x)·s·N(x); factor(x) returns the ValGradLap of g."""
    def vgl(params, x, scale=1.0):
        n = net_vgl(params, x)
        g = factor(x)
        val = g.value * n.value
        grad = g.value[:, None] * n.grad + n.value[:, None] * g.grad
        lap = (g.value * n.lap + 2.0 * torch.sum(g.grad * n.grad, dim=-1)
               + n.value * g.lap)
        return ValGradLap(scale * val, scale * grad, scale * lap)

    def value(params, x, scale=1.0):
        return scale * factor(x).value * net_value(params, x)

    return Ansatz(vgl, value)


def perturbation_ansatz(inner: Ansatz, base: Callable) -> Ansatz:
    """ψ = φ_base(x) + inner(x), base(x) a ValGradLap of the analytic base."""
    def vgl(params, x, scale=1.0):
        n = inner.vgl(params, x, scale)
        b = base(x)
        return ValGradLap(b.value + n.value, b.grad + n.grad, b.lap + n.lap)

    def value(params, x, scale=1.0):
        return base(x).value + inner.value(params, x, scale)

    return Ansatz(vgl, value)


def box_sine_factor(lb: float = 0.0, ub: float = 1.0) -> Callable:
    """g(x) = Π_d sin(π(x_d − lb)/(ub − lb)), the hard Dirichlet factor of
    a box."""
    k = math.pi / (ub - lb)

    def factor(x: torch.Tensor) -> ValGradLap:
        if x.ndim == 1:
            x = x[:, None]
        s = torch.sin(k * (x - lb))       # (N, d)
        c = torch.cos(k * (x - lb))
        val = torch.prod(s, dim=-1)
        d = x.shape[-1]
        # grad_d = k·c_d·Π_{e≠d} s_e, built per dimension so it stays exact
        # at the sine nodes; each sine factor contributes −k² to the lap
        cols = []
        for i in range(d):
            others = (torch.prod(torch.cat([s[:, :i], s[:, i + 1:]], dim=-1), dim=-1)
                      if d > 1 else torch.ones_like(val))
            cols.append(k * c[:, i] * others)
        grad = torch.stack(cols, dim=-1)
        lap = -(k * k) * d * val
        return ValGradLap(val, grad, lap)

    return factor
