"""MLP trial wavefunction, port of `gpe_tpu/models/mlp.py`.

Params keep the JAX package's layout: a tuple of (W, b) pairs with
W: (in, out) — not nn.Linear's (out, in) — so the kernels, the tests and the
weight carry (`params_from_numpy`) all see one layout.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from gpe_tpu_torch.device import resolve_device
from gpe_tpu_torch.ops.laplacian import activation_triple, fwdlap_mlp
from gpe_tpu_torch.physics.bases import ValGradLap


def init_mlp(layers: Sequence[int], scheme: str = "xavier_uniform",
             mode: int = 0, generator: torch.Generator | None = None,
             dtype=torch.float32, device=None):
    """Initialise MLP params on `device` (None → the CUDA card) from
    `generator`, a CPU torch.Generator, so the same seed gives the same
    weights on every device.

    schemes: "xavier_uniform" (bias 0.01), "mode_scaled" (Xavier-normal with
    gain 1/(1+0.2·mode), bias 0.001)."""
    device = resolve_device(device)
    params = []
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        if scheme == "xavier_uniform":
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            w = (torch.rand(fan_in, fan_out, generator=generator,
                            dtype=torch.float64) * 2.0 - 1.0) * lim
            b = torch.full((fan_out,), 0.01, dtype=torch.float64)
        elif scheme == "mode_scaled":
            std = (1.0 / (1.0 + 0.2 * mode)) * math.sqrt(2.0 / (fan_in + fan_out))
            w = std * torch.randn(fan_in, fan_out, generator=generator,
                                  dtype=torch.float64)
            b = torch.full((fan_out,), 0.001, dtype=torch.float64)
        else:
            raise ValueError(f"unknown init scheme {scheme!r}")
        params.append((w.to(device=device, dtype=dtype),
                       b.to(device=device, dtype=dtype)))
    return tuple(params)


def params_from_numpy(params, device=None, dtype=torch.float32):
    """JAX-layout params given as numpy (W, b) pairs → the port's params on
    `device` (None → the CUDA card): the weight carry between the packages."""
    device = resolve_device(device)
    return tuple((torch.tensor(np.asarray(w), dtype=dtype, device=device),
                  torch.tensor(np.asarray(b), dtype=dtype, device=device))
                 for w, b in params)


def mlp_apply(params, x: torch.Tensor, activation: str = "tanh") -> torch.Tensor:
    """Plain forward pass. x: (N, d) → (N,) for scalar-output nets."""
    act = activation_triple(activation)
    h = x[:, None] if x.ndim == 1 else x
    n_layers = len(params)
    for li, (w, b) in enumerate(params):
        h = torch.matmul(h, w) + b
        if li < n_layers - 1:
            h = act(h)[0]
    return h[:, 0] if h.shape[-1] == 1 else h


def mlp_vgl(params, x: torch.Tensor, activation: str = "tanh") -> ValGradLap:
    """(value, grad, laplacian) by forward-Laplacian propagation."""
    return fwdlap_mlp(params, x, activation)
