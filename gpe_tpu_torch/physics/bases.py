"""Analytic base eigenfunctions with closed-form first/second derivatives.

Port of `gpe_tpu/physics/bases.py`:

- Hermite (harmonic trap): φₙ(x) = (2ⁿ n! √π)^(−1/2) Hₙ(x) e^(−x²/2) by the
  stable recurrence, φₙ″ = (x² − (2n+1))·φₙ from the Schrödinger ODE;
- box (infinite well): √(2/L)·sin((n+1)πx/L), and its 2D product;
- Airy (gravity well): Ai(x+αₙ)/|Ai′(αₙ)|, αₙ the Airy zeros. torch has no
  Airy function, so (Ai, Ai′) are tabulated once by scipy on the host at
  the JAX package's 16,384 knots, kept as float32 values as there, and
  evaluated on the device by cubic-Hermite interpolation; Ai″ = z·Ai by the
  Airy ODE. A float64 evaluation therefore matches the JAX package's under
  x64 to round-off, and its float32 evaluation to the f32 interpolation.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from gpe_tpu_torch.device import resolve_device


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


def box_basis(n: int, x: torch.Tensor, L: float = 1.0) -> ValGradLap:
    """φₙ(x) = √(2/L)·sin((n+1)πx/L);  φ″ = −k²φ with k = (n+1)π/L."""
    x = _as_1d(x)
    k = (n + 1) * math.pi / L
    a = math.sqrt(2.0 / L)
    val = a * torch.sin(k * x)
    grad = a * k * torch.cos(k * x)
    lap = -(k * k) * val
    return ValGradLap(val, grad[:, None], lap)


def box_basis_2d(nx: int, ny: int, xy: torch.Tensor, L: float = 1.0) -> ValGradLap:
    """2D box eigenfunction (2/L)·sin(kₓx)·sin(k_y y)."""
    fx = box_basis(nx, xy[:, 0], L)
    fy = box_basis(ny, xy[:, 1], L)
    val = fx.value * fy.value
    grad = torch.stack([fx.grad[:, 0] * fy.value, fx.value * fy.grad[:, 0]],
                       dim=-1)
    lap = fx.lap * fy.value + fx.value * fy.lap
    return ValGradLap(val, grad, lap)


AIRY_ZMIN, AIRY_ZMAX, AIRY_KNOTS = -40.0, 60.0, 16384


@functools.lru_cache(maxsize=1)
def _airy_knots():
    """(Ai, Ai′) at the knots by scipy on the host, rounded to float32 as
    the JAX package stores them, and the knot spacing."""
    from scipy.special import airy
    z = np.linspace(AIRY_ZMIN, AIRY_ZMAX, AIRY_KNOTS)
    ai, aip, _, _ = airy(z)
    return ai.astype(np.float32), aip.astype(np.float32), float(z[1] - z[0])


class AiryTable:
    """The (Ai, Ai′) knots on one device (None → the CUDA card) and their
    cubic-Hermite evaluation: the port of the JAX package's `_AiryTable`."""

    def __init__(self, device=None):
        ai, aip, self.dz = _airy_knots()
        dev = resolve_device(device)
        self.ai = torch.as_tensor(ai, device=dev)
        self.aip = torch.as_tensor(aip, device=dev)

    def __call__(self, z: torch.Tensor):
        """(Ai(z), Ai′(z)) in z's dtype; z clipped to the table's range."""
        z = torch.clamp(z, AIRY_ZMIN, AIRY_ZMAX - 1e-6)
        t = (z - AIRY_ZMIN) / self.dz
        i = torch.clamp(t.to(torch.int64), 0, self.ai.shape[0] - 2)
        s = t - i.to(z.dtype)                   # in [0, 1)
        h = self.dz
        # the knot slopes scaled by h in the knots' float32, as the JAX
        # package's weakly typed product rounds them
        ai, m = self.ai.to(z.dtype), (self.aip * h).to(z.dtype)
        y0, y1 = ai[i], ai[i + 1]
        m0, m1 = m[i], m[i + 1]
        s2, s3 = s * s, s * s * s
        h00 = 2 * s3 - 3 * s2 + 1
        h10 = s3 - 2 * s2 + s
        h01 = -2 * s3 + 3 * s2
        h11 = s3 - s2
        val = h00 * y0 + h10 * m0 + h01 * y1 + h11 * m1
        dh00 = 6 * s2 - 6 * s
        dh10 = 3 * s2 - 4 * s + 1
        dh01 = -dh00
        dh11 = 3 * s2 - 2 * s
        der = (dh00 * y0 + dh10 * m0 + dh01 * y1 + dh11 * m1) / h
        return val, der


@functools.lru_cache(maxsize=None)
def airy_table(device=None) -> AiryTable:
    """The Airy table of `device` (None → the CUDA card), built once."""
    return AiryTable(device)


@functools.lru_cache(maxsize=None)
def airy_zero(n: int) -> float:
    """αₙ = the (n+1)-th zero of Ai (negative), scipy-computed on the host."""
    from scipy.special import ai_zeros
    return float(ai_zeros(max(n + 1, 16))[0][n])


@functools.lru_cache(maxsize=None)
def _airy_norm(n: int) -> float:
    """|Ai′(αₙ)| in float64 on the host: ∫₀^∞ Ai(x+αₙ)² dx = Ai′(αₙ)²."""
    from scipy.special import airy
    return abs(float(airy(airy_zero(n))[1]))


def airy_basis(n: int, x: torch.Tensor) -> ValGradLap:
    """Gravity-well eigenfunction ψₙ(x) = Ai(x + αₙ)/|Ai′(αₙ)| on x ≥ 0,
    on x's device; ψₙ″ = (x + αₙ)·ψₙ by the Airy ODE."""
    x = _as_1d(x)
    z = x + airy_zero(n)
    ai, aip = airy_table(x.device)(z)
    norm = _airy_norm(n)
    val = ai / norm
    return ValGradLap(val, (aip / norm)[:, None], z * val)
