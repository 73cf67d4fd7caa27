"""Imaginary-time (gradient-flow) ground-truth GPE solver, split-step
spectral, port of `gpe_tpu/validate/imaginary_time.py` in float64 torch on
a device (None → the CUDA card).

Propagate ψ ← e^(−τH[ψ])ψ with Strang splitting (half potential+nonlinear,
full kinetic in spectral space, half potential), renormalizing each step;
μ = ∫ c|∇ψ|² + Vψ² + γ|ψ|^(p+1) dx at convergence. Works on uniform grids of
any dimension with two boundary handlings:

- bc="periodic" (rFFT, `torch.fft.rfftn`): for confining potentials whose
  states decay to machine zero inside the box;
- bc="dirichlet" (orthonormal DST-I): the kinetic propagator diagonalizes
  the Dirichlet Laplacian exactly, for non-confining potentials. V is then
  sampled on the n INTERIOR points x_j = lb + j·dx (j = 1..n, box length
  L = (n+1)·dx). torch has no DST, so `_dst1` builds it from an rFFT of the
  odd extension, one axis at a time.

The host reads μ once every 50 steps (the convergence test); every other
step stays on the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gpe_tpu_torch.device import resolve_device

F64 = torch.float64


def as_f64(a, device) -> torch.Tensor:
    """numpy array, list or tensor → float64 tensor on `device`."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a, dtype=np.float64)
    return torch.as_tensor(a, dtype=F64, device=device)


def _axis_view(k: torch.Tensor, axis: int, dim: int) -> torch.Tensor:
    """Reshape a per-axis 1D tensor so it broadcasts along `axis` of a dim-D
    grid."""
    return k.reshape([-1 if j == axis else 1 for j in range(dim)])


def _k_grid(n: int, dx: float, device, half: bool = False) -> torch.Tensor:
    f = torch.fft.rfftfreq if half else torch.fft.fftfreq
    return 2.0 * math.pi * f(n, d=dx, dtype=F64, device=device)


def _dst1(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Orthonormal DST-I along `dim` (involutory): for x of length n, the
    odd extension [0, x, 0, −x reversed] of length 2(n+1) has the rFFT
    X_k = −2i·Σ_j x_j sin(π(j+1)k/(n+1)), so the transform is −Im X_k /
    √(2(n+1)) for k = 1..n."""
    a = a.movedim(dim, -1)
    n = a.shape[-1]
    z = torch.zeros(a.shape[:-1] + (1,), dtype=a.dtype, device=a.device)
    ext = torch.cat([z, a, z, -a.flip(-1)], dim=-1)
    y = torch.fft.rfft(ext, dim=-1).imag[..., 1:n + 1] * (-1.0 / math.sqrt(2.0 * (n + 1)))
    return y.movedim(-1, dim)


def _dstn(a: torch.Tensor) -> torch.Tensor:
    for d in range(a.ndim):
        a = _dst1(a, d)
    return a


def _spectral_ops(shape: tuple, dx: float, bc: str, device):
    """(to_spec, from_spec, k2): forward/inverse transform + the Laplacian
    symbol on the spectral grid for the requested boundary condition."""
    dim = len(shape)
    dims = tuple(range(dim))
    if bc == "periodic":
        ks = [_k_grid(n, dx, device) for n in shape[:-1]]
        ks.append(_k_grid(shape[-1], dx, device, half=True))
        k2 = sum(_axis_view(k, i, dim) ** 2 for i, k in enumerate(ks))
        return (lambda a: torch.fft.rfftn(a, dim=dims),
                lambda a: torch.fft.irfftn(a, s=shape, dim=dims), k2)
    if bc == "dirichlet":
        # sine modes k_m = πm/L, m = 1..n on the n interior points of a box
        # of length L = (n+1)dx
        def axis_k(n):
            return math.pi * torch.arange(1, n + 1, dtype=F64, device=device) / ((n + 1) * dx)

        k2 = sum(_axis_view(axis_k(n), i, dim) ** 2 for i, n in enumerate(shape))
        return _dstn, _dstn, k2
    raise ValueError(f"unknown bc {bc!r}")


def imaginary_time_gpe(V, dx: float, gamma: float, kinetic: float = 1.0,
                       p: float = 3.0, tau: float = 5e-3, steps: int = 20000,
                       tol: float = 1e-12, psi0=None, richardson: bool = False,
                       bc: str = "periodic", device=None):
    """Ground state of −c·Δψ + Vψ + γ|ψ|^(p−1)ψ = μψ with ∫|ψ|² = 1.

    V: (n,) for 1D or (nx, ny) for 2D (same spacing dx per axis), numpy or
    a tensor. Returns (mu, psi): μ a float, ψ a float64 tensor on `device`
    (None → the CUDA card). tol is on the μ change between checks.

    The per-step renormalization leaves an O(τ) bias in μ. richardson=1
    re-converges at τ/2 (warm-started from the τ state) and extrapolates
    μ* = 2μ(τ/2) − μ(τ); richardson=2 adds a third level at τ/4 and
    eliminates the τ² term too.
    """
    dev = resolve_device(device)
    order = int(richardson)
    if order >= 1:
        mu1, psi1 = imaginary_time_gpe(V, dx, gamma, kinetic, p, tau, steps,
                                       tol, psi0, bc=bc, device=dev)
        mu2, psi2 = imaginary_time_gpe(V, dx, gamma, kinetic, p, tau / 2.0,
                                       steps * 2, tol, psi1, bc=bc, device=dev)
        r1 = 2.0 * mu2 - mu1
        if order == 1:
            return r1, psi2
        mu4, psi4 = imaginary_time_gpe(V, dx, gamma, kinetic, p, tau / 4.0,
                                       steps * 4, tol, psi2, bc=bc, device=dev)
        r1_half = 2.0 * mu4 - mu2
        return (4.0 * r1_half - r1) / 3.0, psi4
    V = as_f64(V, dev)
    dim = V.ndim
    vol = dx ** dim
    if psi0 is None:
        psi = torch.exp(-V / (2.0 * max(kinetic, 1e-6)))
        if bc == "dirichlet":
            # taper to the Dirichlet box so the seed has no edge discontinuity
            for i, n in enumerate(V.shape):
                env = torch.sin(math.pi * torch.arange(1, n + 1, dtype=F64, device=dev)
                                / (n + 1))
                psi = psi * _axis_view(env, i, dim)
    else:
        psi = as_f64(psi0, dev).clone()
    psi = psi / torch.sqrt(torch.sum(psi * psi) * vol)

    to_spec, from_spec, k2 = _spectral_ops(tuple(V.shape), dx, bc, dev)
    kin_prop = torch.exp(-tau * kinetic * k2)
    mu_prev = math.inf
    for it in range(steps):
        psi = psi * torch.exp(-0.5 * tau * (V + gamma * psi.abs() ** (p - 1.0)))
        psi = from_spec(to_spec(psi) * kin_prop)
        psi = psi * torch.exp(-0.5 * tau * (V + gamma * psi.abs() ** (p - 1.0)))
        psi = psi / torch.sqrt(torch.sum(psi * psi) * vol)

        if it % 50 == 0 or it == steps - 1:
            mu = _chemical_potential(psi, V, dx, gamma, kinetic, p, bc)
            if abs(mu - mu_prev) < tol * max(1.0, abs(mu)):
                return mu, psi
            mu_prev = mu
    return mu_prev, psi


def _chemical_potential(psi, V, dx, gamma, kinetic, p=3.0, bc="periodic") -> float:
    """μ = ∫ c|∇ψ|² + Vψ² + γ|ψ|^(p+1) (spectral gradient, ∫|ψ|²=1)."""
    dim = psi.ndim
    vol = dx ** dim
    dens = V * psi ** 2 + gamma * psi.abs() ** (p + 1.0)
    if bc == "dirichlet":
        # Parseval for DST-I (ortho): ∫|∇ψ|² dx = vol · Σ k² a²
        to_spec, _, k2 = _spectral_ops(tuple(psi.shape), dx, bc, psi.device)
        a = to_spec(psi)
        return kinetic * float(torch.sum(k2 * a * a)) * vol + float(torch.sum(dens) * vol)
    dims = tuple(range(dim))
    f = torch.fft.rfftn(psi, dim=dims)
    grad2 = torch.zeros_like(psi)
    for i, n in enumerate(psi.shape):
        ki = _axis_view(_k_grid(n, dx, psi.device, half=i == dim - 1), i, dim)
        grad2 = grad2 + torch.fft.irfftn(1j * ki * f, s=tuple(psi.shape), dim=dims) ** 2
    return float(torch.sum(kinetic * grad2 + dens) * vol)
