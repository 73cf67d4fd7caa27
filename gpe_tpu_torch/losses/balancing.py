"""Loss weighting, port of `gpe_tpu/losses/balancing.py` (fixed weights;
self-adaptive and ReLoBRaLo are not ported yet)."""
from __future__ import annotations


def fixed_weights_total(losses: dict, weights: dict):
    """Σ wᵢ·Lᵢ over the keys present in `weights` (missing keys → weight 0)."""
    total = 0.0
    for k, w in weights.items():
        if k in losses:
            total = total + w * losses[k]
    return total
