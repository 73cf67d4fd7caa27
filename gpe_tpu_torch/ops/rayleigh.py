"""GPE Hamiltonian application, port of `gpe_tpu/ops/rayleigh.py`
(`nonlinear_term`, `hamiltonian_apply`)."""
from __future__ import annotations

import torch


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
