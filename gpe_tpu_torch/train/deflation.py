"""Port of `gpe_tpu/train/deflation.py`'s `_normalized_mu`, the μ the
runner's `fit` branch reports (the deflation trainer waits for its port)."""
from __future__ import annotations

import torch

from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.ops.rayleigh import hamiltonian_apply


def _normalized_mu(spec, params, batch, gamma):
    """The Rayleigh quotient of the net's output normalised to ∫u²·w = 1:
    the nonlinear term's strength depends on that normalisation, so the raw
    quotient drifts with the residual normalisation error."""
    with torch.no_grad():
        n = mlp.mlp_vgl(params, batch["x"], spec.activation)
        norm = torch.sqrt(torch.sum(n.value ** 2 * batch["w"]) + 1e-30)
        u = n.value / norm
        lap = n.lap / norm
        hu = hamiltonian_apply(u, lap, batch["V"], gamma, spec.p, spec.kinetic,
                               spec.nonlinearity)
        return torch.sum(u * hu) / (torch.sum(u * u) + 1e-12)
