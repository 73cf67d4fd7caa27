"""Trapping potentials V(x), port of `gpe_tpu/physics/potentials.py`.

Every potential takes x of shape (N, d) (or (N,), read as d=1) and returns
(N,). `get_potential(name, **kw)` returns a unary callable.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch

Potential = Callable[[torch.Tensor], torch.Tensor]


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.ndim == 1 else x


def harmonic(x, a: float = 1.0):
    """V = a·|x|²."""
    x = _as_2d(x)
    return a * torch.sum(x * x, dim=-1)


def gaussian(x, V0: float = 1.0, center=0.0, sigma: float = 0.7071067811865476):
    """V = V0·exp(−|x−c|²/(2σ²))."""
    x = _as_2d(x)
    c = torch.as_tensor(center, dtype=x.dtype, device=x.device)
    c = torch.broadcast_to(c, x.shape[-1:])
    r2 = torch.sum((x - c) ** 2, dim=-1)
    return V0 * torch.exp(-r2 / (2.0 * sigma ** 2))


def periodic(x, V0: float = 1.0, k: float = 2.0 * math.pi / 5.0):
    """V = V0·Σ_d cos²(k·x_d)."""
    x = _as_2d(x)
    return V0 * torch.sum(torch.cos(k * x) ** 2, dim=-1)


def box(x):
    """V = 0 inside the box (the wall is a hard-BC factor, not a potential)."""
    x = _as_2d(x)
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def linear(x, g: float = 1.0):
    """Gravity well V = g·Σ_d x_d."""
    x = _as_2d(x)
    return g * torch.sum(x, dim=-1)


def double_well(x, a: float = 1.0, b: float = 4.0):
    """V = a·|x|⁴ − b·|x|²."""
    x = _as_2d(x)
    r2 = torch.sum(x * x, dim=-1)
    return a * r2 * r2 - b * r2


def step(x, V0: float = 1.0, x0: float = 0.0):
    """V = V0·1[x>x0], summed over dimensions."""
    x = _as_2d(x)
    return V0 * torch.sum((x > x0).to(x.dtype), dim=-1)


def sine(x, V0: float = 1.0, k: float = 1.0):
    """V = V0·Σ_d sin(k·x_d)."""
    x = _as_2d(x)
    return V0 * torch.sum(torch.sin(k * x), dim=-1)


def optical_lattice(x, V0: float = 1.0, k: float = math.pi):
    """V = V0·Σ_d sin²(k·x_d)."""
    x = _as_2d(x)
    return V0 * torch.sum(torch.sin(k * x) ** 2, dim=-1)


def scaled(potential: Potential, beta: float) -> Potential:
    """β-scaled potential V_eff = β·V(x)."""
    def _v(x):
        return beta * potential(x)
    return _v


POTENTIALS = {
    "harmonic": harmonic,
    "gaussian": gaussian,
    "periodic": periodic,
    "box": box,
    "linear": linear,
    "gravity_well": linear,
    "double_well": double_well,
    "step": step,
    "sine": sine,
    "optical_lattice": optical_lattice,
}


def get_potential(name: str, beta: float | None = None, **kwargs) -> Potential:
    """Look up a potential by name, bind kwargs, optionally β-scale it."""
    try:
        fn = POTENTIALS[name]
    except KeyError:
        raise ValueError(f"unknown potential {name!r}; have {sorted(POTENTIALS)}")
    v = functools.partial(fn, **kwargs) if kwargs else fn
    return scaled(v, beta) if beta is not None else v
