"""Numeric base eigenfunctions, port of `gpe_tpu/physics/numeric.py`:
PL-PINN bases for potentials without an analytic linear eigenbasis (the
optical lattice, double wells, arbitrary traps).

A float64 grid eigenstate on the interior DST-I grid of [lb, ub]^d (from
`validate/imaginary_time.py` with bc="dirichlet", or `validate/fdm.py`)
becomes a base with spectrally exact derivatives: the state is expanded in
the Dirichlet sine series

    ψ(x, y) = Σ_{j,k} a_{jk} sin(jπ(x−lb)/L) sin(kπ(y−lb)/L)

by the orthonormal DST-I (`validate/imaginary_time._dstn`, the transform
that diagonalises the oracle's Dirichlet kinetic propagator), and value, ∇
and Δ at arbitrary points are the analytic derivatives of the truncated
series, evaluated in float64 on the points' device by one (P×n)(n×n)
product a field. The triple is therefore self-consistent (Δ is the
Laplacian of the value), which the GPE residual loss needs; interpolating ψ
and differencing would not be.

Bases register by name into NUMERIC_BASES; `GPESpec(basis="numeric:<name>")`
resolves through `train.problem.base_triple`. Registration is process-local:
register before building batches (and after a resume).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gpe_tpu_torch.physics.bases import ValGradLap
from gpe_tpu_torch.validate.imaginary_time import _dstn, as_f64

F64 = torch.float64

#: "numeric:<name>" -> callable(mode, pts) -> ValGradLap (float64 on pts' device)
NUMERIC_BASES: dict = {}


def _check_grid(xi: np.ndarray, lb: float, ub: float) -> None:
    n = xi.shape[0]
    h = (ub - lb) / (n + 1)
    if not (np.allclose(xi[0], lb + h) and np.allclose(xi[-1], ub - h)):
        raise ValueError("xi is not the interior DST-I grid of [lb,ub]")


def _points(pts) -> torch.Tensor:
    """Points as a float64 tensor on their own device (numpy → CPU)."""
    if isinstance(pts, torch.Tensor):
        return pts.to(F64)
    return torch.as_tensor(np.asarray(pts, np.float64))


class SineSeries2D:
    """Dirichlet sine-series representation of a 2D grid state.

    xi: interior grid nodes (n,), uniform, xi[j] = lb + (j+1)·h with
    h = (ub−lb)/(n+1) — the validate/imaginary_time.py DST-I layout.
    psi: (n, n) state values on xi×xi (indexing="ij"); numpy or a tensor.
    """

    def __init__(self, xi, psi, lb: float, ub: float):
        xi = np.asarray(xi.cpu() if isinstance(xi, torch.Tensor) else xi, np.float64)
        psi = as_f64(psi, "cpu")
        n = xi.shape[0]
        if tuple(psi.shape) != (n, n):
            raise ValueError(f"psi shape {tuple(psi.shape)} != ({n},{n})")
        _check_grid(xi, lb, ub)
        self.lb, self.ub, self.n = float(lb), float(ub), n
        # the orthonormal DST-I is its own inverse, so these are ψ's
        # coefficients in the orthonormal sine basis √(2/(n+1))·sin(jπ(x−lb)/L)
        # on the grid; rescaled to plain sin() coefficients for off-grid use
        a = _dstn(psi) * (2.0 / (n + 1))
        k = math.pi * torch.arange(1, n + 1, dtype=F64) / (ub - lb)
        self.k = k                                    # (n,) wavenumbers
        self.a = a                                    # value coefficients
        self.ax = a * k[:, None]                      # ∂x (cos on axis 0)
        self.ay = a * k[None, :]                      # ∂y (cos on axis 1)
        self.alap = -a * (k[:, None] ** 2 + k[None, :] ** 2)

    def __call__(self, pts) -> ValGradLap:
        """(value, grad, lap) at arbitrary points pts (P, 2), in float64 on
        the points' device."""
        pts = _points(pts)
        k = self.k.to(pts.device)
        tx = (pts[:, 0] - self.lb)[:, None] * k
        ty = (pts[:, 1] - self.lb)[:, None] * k
        Sx, Cx, Sy, Cy = torch.sin(tx), torch.cos(tx), torch.sin(ty), torch.cos(ty)
        # Σ_jk S_pj a_jk S'_pk as one product and a row-wise dot
        val = torch.sum((Sx @ self.a.to(pts.device)) * Sy, dim=1)
        gx = torch.sum((Cx @ self.ax.to(pts.device)) * Sy, dim=1)
        gy = torch.sum((Sx @ self.ay.to(pts.device)) * Cy, dim=1)
        lap = torch.sum((Sx @ self.alap.to(pts.device)) * Sy, dim=1)
        return ValGradLap(val, torch.stack([gx, gy], -1), lap)


class SineSeries1D:
    """1D Dirichlet sine-series numeric base (same layout as the 2D case)."""

    def __init__(self, xi, psi, lb: float, ub: float):
        xi = np.asarray(xi.cpu() if isinstance(xi, torch.Tensor) else xi, np.float64)
        psi = as_f64(psi, "cpu")
        n = xi.shape[0]
        _check_grid(xi, lb, ub)
        self.lb, self.ub = float(lb), float(ub)
        self.k = math.pi * torch.arange(1, n + 1, dtype=F64) / (ub - lb)
        self.a = _dstn(psi) * math.sqrt(2.0 / (n + 1))

    def __call__(self, pts) -> ValGradLap:
        pts = _points(pts)
        k, a = self.k.to(pts.device), self.a.to(pts.device)
        t = ((pts[:, 0] if pts.ndim == 2 else pts) - self.lb)[:, None] * k
        S, C = torch.sin(t), torch.cos(t)
        return ValGradLap(S @ a, (C @ (a * k))[:, None], S @ (-a * k ** 2))


def register_numeric_basis(name: str, series_by_mode) -> str:
    """Register sine-series bases under ``"numeric:<name>"``.

    series_by_mode: a single SineSeries* (mode 0 only) or {mode: series}.
    Returns the spec.basis string to use."""
    if not isinstance(series_by_mode, dict):
        series_by_mode = {0: series_by_mode}

    def basis_fn(mode: int, pts):
        if mode not in series_by_mode:
            raise KeyError(f"numeric basis {name!r} has no mode {mode}")
        return series_by_mode[mode](pts)

    key = f"numeric:{name}"
    NUMERIC_BASES[key] = basis_fn
    return key
