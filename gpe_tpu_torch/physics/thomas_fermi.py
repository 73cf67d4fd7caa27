"""Thomas-Fermi approximation — validation curve for strong interactions,
port of `gpe_tpu/physics/thomas_fermi.py`.

Reference: compute_thomas_fermi_approx
(src/gross_pitaevskii_1D_Different_Optimizers.py:157-182). The closed-form
μ's take γ as a float or a tensor and return the same kind.
"""
from __future__ import annotations

import math

import torch


def thomas_fermi(mu, V: torch.Tensor, gamma, clamp: bool = True) -> torch.Tensor:
    """ψ_TF(x) = √(max(0, (μ − V(x))/γ)).

    In the TF limit (large γ) the kinetic term is negligible and the GPE gives
    γ|ψ|² = μ − V wherever positive. ``clamp=False`` reproduces the reference's
    unclamped variant (src/..._Different_Modes.py:156-182).
    """
    arg = (mu - V) / gamma
    if clamp:
        arg = torch.clamp(arg, min=0.0)
    return torch.sqrt(arg)


def thomas_fermi_mu_1d_harmonic(gamma, a: float = 1.0, kinetic: float = 1.0):
    """Closed-form TF chemical potential for the 1D harmonic trap V = a·x².

    Normalization ∫|ψ_TF|² dx = 1 with γ|ψ|² = μ − a·x² on |x|<√(μ/a) gives
    μ_TF = (3γ√a/4)^(2/3). Independent of the kinetic prefactor (TF drops it).
    """
    return (3.0 * gamma * math.sqrt(a) / 4.0) ** (2.0 / 3.0)


def thomas_fermi_mu_2d_harmonic(gamma, a: float = 0.5):
    """TF μ for the 2D harmonic trap V = a·(x²+y²): μ_TF = √(2aγ/π).

    From ∫(μ−a r²)/γ d²r = 1 over r<√(μ/a): πμ²/(2aγ) = 1.
    """
    return (2.0 * a * gamma / math.pi) ** 0.5


def thomas_fermi_mu_3d_harmonic(gamma, a: float = 0.5):
    """TF μ for the 3D harmonic trap V = a·(x²+y²+z²).

    From ∫(μ−a r²)/γ d³r = 1 over r<√(μ/a): 8πμ^{5/2}/(15γa^{3/2}) = 1,
    so μ_TF = (15γa^{3/2}/(8π))^{2/5}.
    """
    return (15.0 * gamma * a ** 1.5 / (8.0 * math.pi)) ** 0.4
