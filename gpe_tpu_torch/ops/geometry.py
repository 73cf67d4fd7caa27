"""Sampling geometries beyond the square grid, port of `gpe_tpu/ops/geometry.py`:
the disk of the reference's 2D script (interior points in a sunflower
layout, equal-area weights, rim probes). Built in float64 numpy on the
host, stored in `dtype` on `device` (None → the CUDA card)."""
from __future__ import annotations

import numpy as np
import torch

from gpe_tpu_torch.device import resolve_device

_GOLDEN_ANGLE = np.pi * (3.0 - np.sqrt(5.0))


def disk_points(center, radius: float, n: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """n interior points of a disk, r_i = R·√((i+½)/n), θ_i = i·golden
    angle (uniform density). (n, 2)."""
    i = np.arange(n, dtype=np.float64)
    r = radius * np.sqrt((i + 0.5) / n)
    th = i * _GOLDEN_ANGLE
    pts = np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)
    return torch.as_tensor(pts + np.asarray(center, np.float64), dtype=dtype,
                           device=resolve_device(device))


def circle_points(center, radius: float, n: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """n equispaced points on the rim (the Dirichlet probes). (n, 2)."""
    th = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    pts = np.stack([radius * np.cos(th), radius * np.sin(th)], axis=-1)
    return torch.as_tensor(pts + np.asarray(center, np.float64), dtype=dtype,
                           device=resolve_device(device))


def disk_weights(radius: float, n: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Equal-area weights for `disk_points`: w_i = πR²/n."""
    return torch.full((n,), np.pi * radius * radius / n, dtype=dtype,
                      device=resolve_device(device))
