"""Exact linear (γ=0) eigenvalues — the test oracles, port of
`gpe_tpu/physics/exact.py`.

Conventions: the reference's refine code solves −ψ″ + V ψ = μψ (kinetic=1);
its notebooks solve −½ψ″ + Vψ = μψ (kinetic=½). All formulas below take the
kinetic prefactor explicitly so both are covered.
"""
from __future__ import annotations

import math

from gpe_tpu_torch.physics.bases import airy_zero


def harmonic_eigenvalue(n: int, a: float = 1.0, kinetic: float = 1.0) -> float:
    """μₙ for −c·ψ″ + a·x²ψ = μψ:  μₙ = 2√(c·a)·(n + ½).

    kinetic=1, a=1 → μₙ = 2n+1 (refine code); kinetic=½, a=½ → μₙ = n+½.
    """
    return 2.0 * math.sqrt(kinetic * a) * (n + 0.5)


def harmonic_eigenvalue_2d(nx: int, ny: int, a: float = 1.0, kinetic: float = 1.0) -> float:
    """μ for the 2D isotropic harmonic trap: 2√(c·a)·(nx + ny + 1)."""
    return 2.0 * math.sqrt(kinetic * a) * (nx + ny + 1.0)


def box_eigenvalue(n: int, L: float = 1.0, kinetic: float = 1.0) -> float:
    """μₙ = c·((n+1)π/L)² for the infinite well of width L."""
    return kinetic * ((n + 1) * math.pi / L) ** 2


def box_eigenvalue_2d(nx: int, ny: int, L: float = 1.0, kinetic: float = 1.0) -> float:
    return box_eigenvalue(nx, L, kinetic) + box_eigenvalue(ny, L, kinetic)


def gravity_well_eigenvalue(n: int, g: float = 1.0, kinetic: float = 1.0) -> float:
    """μₙ = −αₙ·(c·g²)^(1/3) for −c·ψ″ + g·x·ψ = μψ on x≥0 (αₙ = Airy zeros)."""
    return -airy_zero(n) * (kinetic * g * g) ** (1.0 / 3.0)
