"""Analytic base eigenfunctions with closed-form first/second derivatives.

Port of `gpe_tpu/physics/bases.py` for the Hermite (harmonic-trap) family:
φₙ(x) = (2ⁿ n! √π)^(−1/2) Hₙ(x) e^(−x²/2) by the stable recurrence, with
φₙ″ = (x² − (2n+1))·φₙ from the Schrödinger ODE. The box and Airy bases
are not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ValGradLap(NamedTuple):
    """A function's value (N,), gradient (N, d) and Laplacian (N,)."""
    value: torch.Tensor
    grad: torch.Tensor
    lap: torch.Tensor


def _as_1d(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 2:
        if x.shape[-1] != 1:
            raise ValueError(f"1D basis got x with d={x.shape[-1]}")
        x = x[:, 0]
    return x


def _hermite_poly_pair(n: int, x: torch.Tensor):
    """Physicists' Hₙ(x) and Hₙ₋₁(x): H_{k+1} = 2x·H_k − 2k·H_{k−1}."""
    h_prev = torch.ones_like(x)
    if n == 0:
        return h_prev, torch.zeros_like(x)
    h = 2.0 * x
    for k in range(1, n):
        h, h_prev = 2.0 * x * h - 2.0 * k * h_prev, h
    return h, h_prev


def hermite_basis(n: int, x: torch.Tensor, scale: float = 1.0) -> ValGradLap:
    """Normalised harmonic-oscillator eigenfunction φₙ (−Δ + x² convention
    when scale=1; the same φₙ serves −½Δ + ½x² with eigenvalue n + ½)."""
    x = _as_1d(x) * scale
    c = 1.0 / math.sqrt((2.0 ** n) * math.factorial(n) * math.sqrt(math.pi))
    hn, hnm1 = _hermite_poly_pair(n, x)
    w = torch.exp(-0.5 * x * x)
    val = c * hn * w
    grad = c * (2.0 * n * hnm1 - x * hn) * w * scale
    lap = (x * x - (2.0 * n + 1.0)) * val * scale * scale
    return ValGradLap(val, grad[:, None], lap)


def hermite_product_2d(nx: int, ny: int, xy: torch.Tensor) -> ValGradLap:
    """2D trap eigenfunction φ_{nx}(x)·φ_{ny}(y) from the 1D triples."""
    fx = hermite_basis(nx, xy[:, 0])
    fy = hermite_basis(ny, xy[:, 1])
    val = fx.value * fy.value
    grad = torch.stack([fx.grad[:, 0] * fy.value, fx.value * fy.grad[:, 0]],
                       dim=-1)
    lap = fx.lap * fy.value + fx.value * fy.lap
    return ValGradLap(val, grad, lap)


def hermite_product_nd(modes, x: torch.Tensor) -> ValGradLap:
    """d-D trap eigenfunction Π_i φ_{n_i}(x_i) by the product rule."""
    d = x.shape[-1]
    if len(modes) != d:
        raise ValueError(f"{len(modes)} modes for d={d}")
    fs = [hermite_basis(int(m), x[:, i]) for i, m in enumerate(modes)]
    vals = [f.value for f in fs]

    def prod_except(i):
        out = None
        for j, v in enumerate(vals):
            if j != i:
                out = v if out is None else out * v
        return out if out is not None else torch.ones_like(vals[0])

    val = vals[0]
    for v in vals[1:]:
        val = val * v
    grad = torch.stack([fs[i].grad[:, 0] * prod_except(i) for i in range(d)],
                       dim=-1)
    lap = sum(fs[i].lap * prod_except(i) for i in range(d))
    return ValGradLap(val, grad, lap)
