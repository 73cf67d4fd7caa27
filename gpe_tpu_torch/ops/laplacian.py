"""Forward-Laplacian MLP propagation, port of `gpe_tpu/ops/laplacian.py`.

The value, the d Jacobian rows and the Laplacian travel forward through the
net as one (N, d+2, F) state; each linear layer acts on all channels with
ONE matmul (bias on the value channel only), each activation updates them
with σ, σ′, σ″:  v ← σ(z),  J ← σ′(z)·J,  L ← σ′(z)·L + σ″(z)·Σ_d J².
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from gpe_tpu_torch.physics.bases import ValGradLap


def _tanh_triple(y):
    t = torch.tanh(y)
    d1 = 1.0 - t * t
    return t, d1, -2.0 * t * d1


def _shifted_tanh_triple(y, eps: float = 1e-6):
    """tanh(y) + 1 + ε, the reference's strictly positive activation."""
    t = torch.tanh(y)
    d1 = 1.0 - t * t
    return t + 1.0 + eps, d1, -2.0 * t * d1


def _sin_triple(y):
    s = torch.sin(y)
    return s, torch.cos(y), -s


def _gelu_triple(y):
    c = 0.7978845608028654  # √(2/π)
    a = 0.044715
    u = c * (y + a * y ** 3)
    t = torch.tanh(u)
    du = c * (1.0 + 3.0 * a * y * y)
    d2u = c * 6.0 * a * y
    sech2 = 1.0 - t * t
    val = 0.5 * y * (1.0 + t)
    d1 = 0.5 * (1.0 + t) + 0.5 * y * sech2 * du
    d2 = sech2 * du + 0.5 * y * (sech2 * d2u - 2.0 * t * sech2 * du * du)
    return val, d1, d2


ACTIVATIONS = {
    "tanh": _tanh_triple,
    "shifted_tanh": _shifted_tanh_triple,
    "sin": _sin_triple,
    "gelu": _gelu_triple,
}


def activation_triple(name: str) -> Callable:
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; have {sorted(ACTIVATIONS)}")


def _tanh_quad(y):
    t = torch.tanh(y)
    d1 = 1.0 - t * t
    return t, d1, -2.0 * t * d1, (6.0 * t * t - 2.0) * d1


def _shifted_tanh_quad(y, eps: float = 1e-6):
    t, d1, d2, d3 = _tanh_quad(y)
    return t + 1.0 + eps, d1, d2, d3


def _sin_quad(y):
    s, c = torch.sin(y), torch.cos(y)
    return s, c, -s, -c


ACTIVATION_QUADS = {
    "tanh": _tanh_quad,
    "shifted_tanh": _shifted_tanh_quad,
    "sin": _sin_quad,
}


def _tanh_from_vals(s0, s1):
    s2 = -2.0 * s0 * s1
    return s2, -2.0 * (s1 * s1 + s0 * s2)


def _shifted_tanh_from_vals(s0, s1, eps: float = 1e-6):
    t = s0 - 1.0 - eps
    s2 = -2.0 * t * s1
    return s2, -2.0 * (s1 * s1 + t * s2)


def _sin_from_vals(s0, s1):
    return -s0, -s1


ACTIVATION_FROM_VALUES = {
    "tanh": _tanh_from_vals,
    "shifted_tanh": _shifted_tanh_from_vals,
    "sin": _sin_from_vals,
}


def fwdlap_mlp(params: Sequence[tuple], x: torch.Tensor,
               activation: str = "tanh") -> ValGradLap:
    """Value/gradient/Laplacian of an MLP in one forward pass.

    params: sequence of (W, b) with W: (in, out). x: (N, d). Returns
    value (N,), grad (N, d), lap (N,) for scalar-output nets (trailing output
    axes otherwise)."""
    act = activation_triple(activation)
    if x.ndim == 1:
        x = x[:, None]
    N, d = x.shape
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    s = torch.cat([x[:, None, :], eye.expand(N, d, d),
                   torch.zeros(N, 1, d, dtype=x.dtype, device=x.device)],
                  dim=1)                                  # (N, d+2, d)
    n_layers = len(params)
    for li, (w, b) in enumerate(params):
        s = torch.matmul(s, w)                            # one GEMM, all channels
        s = torch.cat([s[:, :1] + b, s[:, 1:]], dim=1)
        if li < n_layers - 1:
            val, d1, d2 = act(s[:, 0, :])
            jac = s[:, 1:1 + d, :]
            lap = s[:, 1 + d, :]
            lap_new = d1 * lap + d2 * torch.sum(jac * jac, dim=1)
            s = torch.cat([val[:, None], d1[:, None] * jac, lap_new[:, None]],
                          dim=1)
    out, jac, lap = s[:, 0, :], s[:, 1:1 + d, :], s[:, 1 + d, :]
    if out.shape[-1] == 1:
        return ValGradLap(out[:, 0], jac[:, :, 0], lap[:, 0])
    return ValGradLap(out, jac, lap)
