"""Loss weighting, port of `gpe_tpu/losses/balancing.py`: fixed,
self-adaptive and ReLoBRaLo weights (`train/balanced.py` trains with the
last)."""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


def fixed_weights_total(losses: dict, weights: dict):
    """Σ wᵢ·Lᵢ over the keys present in `weights` (missing keys → weight 0)."""
    total = 0.0
    for k, w in weights.items():
        if k in losses:
            total = total + w * losses[k]
    return total


def init_log_alpha(names: Sequence[str], dtype=torch.float32, device=None) -> dict:
    """Learnable log-weights, one per loss term, initialised to 0 (weight 1)."""
    return {k: torch.zeros((), dtype=dtype, device=device) for k in names}


def self_adaptive_total(losses: dict, log_alpha: dict,
                        base_weights: dict | None = None):
    """Σ wᵢ·exp(log_alphaᵢ)·Lᵢ with log_alpha trained jointly. The value is
    the weighted sum, but log_alpha gets an ASCENT gradient by the
    2·w.detach() − w trick (the SA-PINN min-max: the net descends the
    weighted loss, the weights climb toward the hardest terms); plain joint
    minimisation would drive log_alpha → −∞."""
    total = 0.0
    for k, la in log_alpha.items():
        if k in losses:
            w = torch.exp(la) * (1.0 if base_weights is None
                                 else base_weights.get(k, 1.0))
            w_eff = 2.0 * w.detach() - w
            total = total + w_eff * losses[k]
    return total


class ReloBRaLoState(NamedTuple):
    lambdas: torch.Tensor       # (n_terms,) balancing weights
    last_losses: torch.Tensor   # (n_terms,)
    init_losses: torch.Tensor   # (n_terms,)
    step: torch.Tensor          # () int32


def relobralo_init(n_terms: int, device=None) -> ReloBRaLoState:
    ones = lambda: torch.ones((n_terms,), dtype=torch.float32, device=device)
    return ReloBRaLoState(ones(), ones(), ones(),
                          torch.zeros((), dtype=torch.int32, device=device))


def relobralo_step(state: ReloBRaLoState, losses: torch.Tensor,
                   generator: torch.Generator, alpha: float = 0.999,
                   temperature: float = 0.1, rho: float = 0.999,
                   eps: float = 1e-12):
    """One ReLoBRaLo update (Relative Loss Balancing with Random Lookback).
    losses: (n_terms,) current raw loss values, detached. The Bernoulli(ρ)
    lookback is drawn from `generator` (a generator on the losses' device),
    as `uniform < ρ`: always True at ρ = 1, always False at ρ = 0.

    Returns (weights, new_state); weights multiply the raw losses (callers
    may further multiply by manual weights, as the reference does)."""
    n = losses.shape[0]
    first = state.step == 0
    init_losses = torch.where(first, losses, state.init_losses)
    last_losses = torch.where(first, losses, state.last_losses)

    def bal(ref):
        z = losses / (temperature * (ref + eps))
        return n * torch.softmax(z - torch.max(z), dim=0)

    lam_hat = bal(last_losses)       # against the previous step
    lam_init = bal(init_losses)      # the random lookback's target
    use_last = torch.rand((), generator=generator, device=losses.device) < rho
    lam_lookback = torch.where(use_last, lam_hat, lam_init)
    lambdas = (alpha * (rho * state.lambdas + (1.0 - rho) * lam_lookback)
               + (1.0 - alpha) * lam_hat)
    lambdas = torch.where(first, torch.ones_like(lambdas), lambdas)
    return lambdas, ReloBRaLoState(lambdas, losses, init_losses, state.step + 1)
