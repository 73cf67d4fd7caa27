"""Loss weighting, port of `gpe_tpu/losses/balancing.py`: fixed and
self-adaptive weights (ReLoBRaLo waits for its trainer)."""
from __future__ import annotations

from typing import Sequence

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
