"""GPE loss terms, port of `gpe_tpu/losses/gpe.py` for the terms of the
main path: PDE residual, boundary and the Riemann normalisation. The other
terms raise NotImplementedError naming the JAX function that has them."""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from gpe_tpu_torch.ops.rayleigh import hamiltonian_apply


@dataclass(frozen=True)
class GPETerms:
    """Static configuration of the GPE loss terms."""
    p: float = 3.0
    kinetic: float = 1.0
    nonlinearity: str = "abs_power"
    norm_style: str = "riemann"
    symmetry: str | None = None
    use_riesz: bool = False
    anti_trivial: bool = False
    anti_trivial_c: float = 2.0
    width_penalty: bool = False
    mu_report_shift: float = 0.0


class TermsOutput(NamedTuple):
    losses: dict          # name -> scalar loss term
    mu: torch.Tensor      # Rayleigh-quotient eigenvalue
    u: torch.Tensor       # complete solution on the collocation points


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet; see gpe_tpu.losses.gpe.gpe_terms")


def gpe_terms(u, grad, lap, bv, V, w, gamma, cfg: GPETerms) -> TermsOutput:
    """pde + boundary + norm from precomputed complete-solution arrays."""
    if cfg.norm_style != "riemann":
        _unported(f"norm_style={cfg.norm_style!r}")
    if cfg.symmetry is not None:
        _unported("the symmetry term")
    if cfg.use_riesz:
        _unported("the Riesz energy term")
    if cfg.width_penalty:
        _unported("the width penalty")
    if cfg.anti_trivial:
        _unported("the anti-trivial regularizers")
    if cfg.mu_report_shift:
        _unported("mu_report_shift")
    del grad                       # only the Riesz term reads ∇ψ
    hu = hamiltonian_apply(u, lap, V, gamma, cfg.p, cfg.kinetic,
                           cfg.nonlinearity)

    def _red(v):
        # at least f32 accumulation: the bf16 path keeps activations and
        # GEMMs in bf16 but every quadrature sum in f32
        return torch.sum(v, dtype=torch.promote_types(v.dtype, torch.float32))

    n_pts = u.shape[0]
    den = _red(u * u)
    mu = _red(u * hu) / (den + 1e-12)
    r = hu - mu * u
    losses = {"pde": _red(r * r) / n_pts,
              "boundary": torch.mean(bv * bv, dtype=torch.promote_types(
                  bv.dtype, torch.float32)),
              "norm": (_red(u * u * w) - 1.0) ** 2}
    return TermsOutput(losses, mu, u)
