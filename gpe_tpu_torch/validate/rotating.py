"""Rotating-frame 2D GPE ground-truth solver, port of
`gpe_tpu/validate/rotating.py` in complex128 torch on a device.

Solves, for COMPLEX ψ(x, y) with ∫|ψ|² = 1,

    μψ = [ −c·Δ + V + γ|ψ|² − Ω·L_z ] ψ,      L_z = −i(x∂_y − y∂_x),

by imaginary-time evolution with the Bao–Wang ADI splitting: grouping the
rotation with the kinetic terms makes every factor exactly exponentiable,

    A = c·p_x² + Ω·y·p_x   (diagonal after FFT in x),
    B = c·p_y² − Ω·x·p_y   (diagonal after FFT in y),
    C = V + γ|ψ|²          (diagonal in position),

Strang-composed e^{−τC/2} e^{−τA/2} e^{−τB} e^{−τA/2} e^{−τC/2} with per-step
renormalization. The functions of a state (μ, ⟨L_z⟩, E, vortex count) run
where ψ lies; `regrid_psi` splines on the host with scipy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gpe_tpu_torch.device import resolve_device
from gpe_tpu_torch.validate.imaginary_time import F64, as_f64

C128 = torch.complex128


def _grid(psi, V, x):
    """(V, x, X, Y) as float64 tensors on ψ's device."""
    V, x = as_f64(V, psi.device), as_f64(x, psi.device)
    X, Y = torch.meshgrid(x, x, indexing="ij")
    return V, x, X, Y


def _k(n: int, dx: float, device) -> torch.Tensor:
    return 2.0 * math.pi * torch.fft.fftfreq(n, d=dx, dtype=F64, device=device)


def rotating_imaginary_time(V, x, gamma: float, omega: float,
                            kinetic: float = 0.5, tau: float = 2e-3,
                            steps: int = 40000, tol: float = 1e-12, psi0=None,
                            seed_vortex: bool = True, device=None):
    """Ground state of the rotating-frame GPE on a square grid.

    V: (n, n) potential on the tensor grid of 1-D coordinates `x` (numpy or
    tensors). Returns (mu, psi complex128 (n, n) on `device` — None → the
    CUDA card —, lz) with ⟨L_z⟩ the angular momentum. Requires omega < trap
    frequency (the effective radial potential ½(ω_trap²−Ω²)r² must confine).
    The symmetry-breaking noise of the vortex seed is numpy's
    default_rng(0), as in the JAX package.
    """
    dev = resolve_device(device)
    V, x = as_f64(V, dev), as_f64(x, dev)
    n = x.shape[0]
    dx = float(x[1] - x[0])
    vol = dx * dx
    X, Y = torch.meshgrid(x, x, indexing="ij")
    k = _k(n, dx, dev)

    if psi0 is None:
        psi = torch.exp(-(X**2 + Y**2) / 2.0).to(C128)
        if seed_vortex and omega > 0:
            # symmetry-broken seed: a displaced vortex + noise lets imaginary
            # time find vortex ground states instead of a metastable
            # zero-circulation state
            rng = np.random.default_rng(0)
            psi = psi * torch.complex(X - 0.3, Y + 0.2)
            noise = (rng.standard_normal(tuple(psi.shape))
                     + 1j * rng.standard_normal(tuple(psi.shape)))
            psi = psi + 0.01 * torch.as_tensor(noise, dtype=C128, device=dev) * psi.abs().max()
    else:
        psi0 = psi0 if isinstance(psi0, torch.Tensor) else np.asarray(psi0, complex)
        psi = torch.as_tensor(psi0, dtype=C128, device=dev).clone()
    psi = psi / torch.sqrt(torch.sum(psi.abs() ** 2) * vol)

    # A: ½k_x² + Ω·y·k_x  (x-FFT, axis 0); B: ½k_y² − Ω·x·k_y (y-FFT, axis 1)
    symb_A = kinetic * k[:, None] ** 2 + omega * x[None, :] * k[:, None]
    symb_B = kinetic * k[None, :] ** 2 - omega * x[:, None] * k[None, :]
    expA_half = torch.exp(-0.5 * tau * symb_A)
    expB = torch.exp(-tau * symb_B)

    mu_prev = math.inf
    for it in range(steps):
        psi = psi * torch.exp(-0.5 * tau * (V + gamma * psi.abs() ** 2))
        psi = torch.fft.ifft(torch.fft.fft(psi, dim=0) * expA_half, dim=0)
        psi = torch.fft.ifft(torch.fft.fft(psi, dim=1) * expB, dim=1)
        psi = torch.fft.ifft(torch.fft.fft(psi, dim=0) * expA_half, dim=0)
        psi = psi * torch.exp(-0.5 * tau * (V + gamma * psi.abs() ** 2))
        psi = psi / torch.sqrt(torch.sum(psi.abs() ** 2) * vol)

        if it % 100 == 0 or it == steps - 1:
            mu = rotating_mu(psi, V, x, gamma, omega, kinetic)
            if abs(mu - mu_prev) < tol * max(1.0, abs(mu)):
                break
            mu_prev = mu
    mu = rotating_mu(psi, V, x, gamma, omega, kinetic)
    return mu, psi, angular_momentum(psi, x)


def _spectral_grads(psi: torch.Tensor, dx: float):
    k = _k(psi.shape[0], dx, psi.device)
    gx = torch.fft.ifft(1j * k[:, None] * torch.fft.fft(psi, dim=0), dim=0)
    gy = torch.fft.ifft(1j * k[None, :] * torch.fft.fft(psi, dim=1), dim=1)
    return gx, gy


def _energy_density(psi, V, x, gamma, omega, kinetic, nonlin_weight):
    """Σ over the grid of c|∇ψ|² + V|ψ|² + w·γ|ψ|⁴ − Ω·Re(ψ* L_z ψ), times dx²."""
    psi = torch.as_tensor(psi)
    V, x, X, Y = _grid(psi, V, x)
    dx = float(x[1] - x[0])
    gx, gy = _spectral_grads(psi, dx)
    grad2 = gx.abs() ** 2 + gy.abs() ** 2
    lz_dens = torch.real(torch.conj(psi) * (-1j) * (X * gy - Y * gx))
    dens = (kinetic * grad2 + V * psi.abs() ** 2
            + nonlin_weight * gamma * psi.abs() ** 4 - omega * lz_dens)
    return float(torch.sum(dens) * dx * dx)


def rotating_mu(psi, V, x, gamma, omega, kinetic=0.5) -> float:
    """μ = ∫ c|∇ψ|² + V|ψ|² + γ|ψ|⁴ − Ω·ψ*L_zψ  (∫|ψ|²=1)."""
    return _energy_density(psi, V, x, gamma, omega, kinetic, 1.0)


def rotating_energy(psi, V, x, gamma, omega, kinetic=0.5) -> float:
    """Rotating-frame GP energy functional (∫|ψ|²=1):
    E[ψ] = ∫ c|∇ψ|² + V|ψ|² + (γ/2)|ψ|⁴ − Ω·ψ*L_zψ.

    Differs from μ (rotating_mu) by the ½ on the interaction term; E decides
    which of two near-degenerate vortex configurations is the ground state."""
    return _energy_density(psi, V, x, gamma, omega, kinetic, 0.5)


def angular_momentum(psi, x) -> float:
    """⟨L_z⟩ = ∫ ψ* (−i)(x∂_y − y∂_x) ψ  (∫|ψ|²=1)."""
    psi = torch.as_tensor(psi)
    x = as_f64(x, psi.device)
    dx = float(x[1] - x[0])
    X, Y = torch.meshgrid(x, x, indexing="ij")
    gx, gy = _spectral_grads(psi, dx)
    lz = torch.real(torch.conj(psi) * (-1j) * (X * gy - Y * gx))
    return float(torch.sum(lz) * dx * dx)


def vortex_count(psi, threshold: float = 0.05, halo: int = 4) -> int:
    """Count phase windings: plaquettes where the accumulated phase around the
    2×2 cell winds by ±2π. A vortex CORE has near-zero density, so the
    spurious-winding mask uses the NEIGHBORHOOD-max density (within `halo`
    cells): a real vortex sits inside bulk condensate, numerical phase noise
    outside the cloud does not."""
    psi = torch.as_tensor(psi)
    ph = torch.angle(psi)

    def d(a, b):
        return torch.angle(torch.exp(1j * (b - a)))

    circ = (d(ph[:-1, :-1], ph[1:, :-1]) + d(ph[1:, :-1], ph[1:, 1:])
            + d(ph[1:, 1:], ph[:-1, 1:]) + d(ph[:-1, 1:], ph[:-1, :-1]))
    dens = psi.abs() ** 2
    neigh = dens.clone()
    for ax in (0, 1):
        for s in range(1, halo + 1):
            neigh = torch.maximum(neigh, torch.roll(dens, s, dims=ax))
            neigh = torch.maximum(neigh, torch.roll(dens, -s, dims=ax))
    mask = neigh[:-1, :-1] > threshold * dens.max()
    return int(torch.sum((circ.abs() > math.pi) & mask))


def regrid_psi(psi, x_src, x_dst, device=None):
    """Cubic-spline regrid of a complex field between uniform tensor grids
    (re/im separately, scipy's RectBivariateSpline on the host),
    renormalized to ∫|ψ|²=1 on the destination grid and returned as
    complex128 on `device` (None → ψ's device if ψ is a tensor, else the
    CUDA card) — the configuration-preserving warm start for grid-refined
    imaginary time."""
    from scipy.interpolate import RectBivariateSpline

    if device is None and isinstance(psi, torch.Tensor):
        device = psi.device
    dev = resolve_device(device)
    p = psi.detach().cpu().numpy() if isinstance(psi, torch.Tensor) else np.asarray(psi)
    xs = as_f64(x_src, "cpu").numpy()
    xd = as_f64(x_dst, "cpu").numpy()
    re = RectBivariateSpline(xs, xs, np.real(p))(xd, xd)
    im = RectBivariateSpline(xs, xs, np.imag(p))(xd, xd)
    out = re + 1j * im
    dx = xd[1] - xd[0]
    out = out / np.sqrt(np.sum(np.abs(out) ** 2) * dx * dx)
    return torch.as_tensor(out, dtype=C128, device=dev)
