"""Wavefunction ansätze, port of `gpe_tpu/models/ansatz.py` (plain only;
the hard-BC and perturbation closures are not ported yet — the perturbation
base enters through the batch arrays in `train/problem.py`)."""
from __future__ import annotations

from typing import Callable, NamedTuple

from gpe_tpu_torch.physics.bases import ValGradLap


class Ansatz(NamedTuple):
    vgl: Callable        # (params, x, scale) -> ValGradLap of ψ
    value: Callable      # (params, x, scale) -> ψ values (N,)


def plain_ansatz(net_vgl: Callable, net_value: Callable) -> Ansatz:
    """ψ = s·N(x)."""
    def vgl(params, x, scale=1.0):
        n = net_vgl(params, x)
        return ValGradLap(scale * n.value, scale * n.grad, scale * n.lap)

    def value(params, x, scale=1.0):
        return scale * net_value(params, x)

    return Ansatz(vgl, value)
