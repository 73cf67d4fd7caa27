"""GPE Hamiltonian application, Rayleigh-quotient μ, residual and Riesz
energy, port of `gpe_tpu/ops/rayleigh.py`. The reductions take an optional
process group (JAX's `axis_name`) for collocation points sharded over its
ranks."""
from __future__ import annotations

import torch

from gpe_tpu_torch.ops.quadrature import integrate, wmean


def nonlinear_term(u, gamma, p: float, kind: str = "abs_power"):
    """γ·𝒩(u): `abs_power` → γ|u|^(p−1)u; `power` → γuᵖ."""
    if kind == "power":
        return gamma * u ** p
    if kind == "abs_power":
        return gamma * torch.abs(u) ** (p - 1) * u
    raise ValueError(f"unknown nonlinearity {kind!r}")


def hamiltonian_apply(u, lap, V, gamma, p: float = 3.0, kinetic: float = 1.0,
                      nonlinearity: str = "abs_power"):
    """Hu = −c·Δu + V·u + γ·𝒩(u) pointwise on collocation points."""
    return -kinetic * lap + V * u + nonlinear_term(u, gamma, p, nonlinearity)


def rayleigh_mu(u, lap, V, gamma, p: float = 3.0, kinetic: float = 1.0,
                nonlinearity: str = "abs_power", group=None, eps: float = 1e-12):
    """μ = ⟨u, Hu⟩/⟨u, u⟩ by point means (the weights cancel in the ratio)."""
    hu = hamiltonian_apply(u, lap, V, gamma, p, kinetic, nonlinearity)
    return wmean(u * hu, group) / (wmean(u * u, group) + eps)


def gpe_residual(u, lap, V, mu, gamma, p: float = 3.0, kinetic: float = 1.0,
                 nonlinearity: str = "abs_power"):
    """r = −c·Δu + V·u + γ·𝒩(u) − μ·u."""
    return hamiltonian_apply(u, lap, V, gamma, p, kinetic, nonlinearity) - mu * u


def riesz_energy(u, grad, V, w, gamma, p: float = 3.0, kinetic: float = 1.0,
                 normalize: bool = True, group=None, eps: float = 1e-12):
    """E[u] = ∫ c|∇u|² + V·u² + (2γ/(p+1))·|u|^(p+1) dx [/ ∫u² if normalize]."""
    grad2 = torch.sum(grad * grad, dim=-1)
    dens = (kinetic * grad2 + V * u * u
            + (2.0 * gamma / (p + 1.0)) * torch.abs(u) ** (p + 1.0))
    e = integrate(dens, w, group)
    if normalize:
        e = e / (integrate(u * u, w, group) + eps)
    return e
