"""GPE loss terms, port of `gpe_tpu/losses/gpe.py`: PDE residual, boundary,
normalisation (Riemann or l2), symmetry, Riesz energy, the width penalty and
the anti-trivial regularizers, from one evaluation of the complete
solution. With an optional process group (JAX's `axis_name`) the
collocation arrays are this rank's shard and every quadrature sum runs
over all ranks; the boundary probes are replicated, so their mean stays
local."""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from gpe_tpu_torch.ops.rayleigh import hamiltonian_apply, riesz_energy
from gpe_tpu_torch.ops.collectives import global_count, psum


@dataclass(frozen=True)
class GPETerms:
    """Static configuration of the GPE loss terms."""
    p: float = 3.0
    kinetic: float = 1.0
    nonlinearity: str = "abs_power"
    norm_style: str = "riemann"          # "(Σu²·dx − 1)²" | "l2": "(‖u‖₂ − 1)²"
    symmetry: str | None = None          # None | "even" | "odd" | "interval" | "y_even"
    use_riesz: bool = False
    anti_trivial: bool = False
    anti_trivial_c: float = 2.0
    width_penalty: bool = False
    mu_report_shift: float = 0.0         # the old notebooks' reported λ + mode


class TermsOutput(NamedTuple):
    losses: dict          # name -> scalar loss term
    mu: torch.Tensor      # Rayleigh-quotient eigenvalue (+ mu_report_shift)
    u: torch.Tensor       # complete solution on the collocation points


def gpe_terms(u, grad, lap, bv, V, w, gamma, cfg: GPETerms, group=None,
              u_reflect=None, x2=None) -> TermsOutput:
    """Every GPE loss term from precomputed complete-solution arrays:
    u, grad, lap (N,), (N, d), (N,); bv (B,) on the boundary probes; V, w
    (N,); u_reflect ψ at the reflected points when cfg.symmetry is set (the
    caller owns the reflection, this applies the sign); x2 = |x|² for the
    width penalty; group the process group of sharded collocation points
    (None: one process)."""
    hu = hamiltonian_apply(u, lap, V, gamma, cfg.p, cfg.kinetic,
                           cfg.nonlinearity)

    def _red(v):
        # at least f32 accumulation: the bf16 path keeps activations and
        # GEMMs in bf16 but every quadrature sum in f32
        return psum(torch.sum(v, dtype=torch.promote_types(v.dtype, torch.float32)),
                    group)

    n_pts = global_count(u.shape[0], group)
    den = _red(u * u)
    mu = _red(u * hu) / (den + 1e-12)
    r = hu - mu * u
    losses = {"pde": _red(r * r) / n_pts,
              "boundary": torch.mean(bv * bv, dtype=torch.promote_types(
                  bv.dtype, torch.float32))}
    if cfg.norm_style == "riemann":
        losses["norm"] = (_red(u * u * w) - 1.0) ** 2
    else:
        losses["norm"] = (torch.sqrt(den) - 1.0) ** 2
    if cfg.symmetry is not None and u_reflect is not None:
        sgn = -1.0 if cfg.symmetry == "odd" else 1.0
        diff = u - sgn * u_reflect
        losses["sym"] = _red(diff * diff) / n_pts
    if cfg.use_riesz:
        losses["riesz"] = riesz_energy(u, grad, V, w, gamma, cfg.p, cfg.kinetic,
                                       normalize=True, group=group)
    if cfg.width_penalty and x2 is not None:
        losses["width"] = -gamma * _red(x2 * u * u) / n_pts
    if cfg.anti_trivial:
        losses["reg_f"] = 1.0 / (den / n_pts + 1e-2)
        losses["reg_lambda"] = 1.0 / (mu * mu + 1e-6)
        losses["reg_drive"] = torch.exp(-mu + cfg.anti_trivial_c)
    return TermsOutput(losses, mu + cfg.mu_report_shift, u)
