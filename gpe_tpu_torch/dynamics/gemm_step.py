"""TDGPE propagation with real GEMMs only, port of
`gpe_tpu/dynamics/gemm_step.py`.

ψ is carried as a real pair (ψ_re, ψ_im) and the kinetic Strang factor is
applied in position space: per axis one dense (n, n) propagator
K = T⁻¹·diag(e^{−iθk²})·T (T = DFT for periodic, the orthonormal DST-I for
Dirichlet), precomputed on the host in float64 and cast, applied as real
matrix products (K_re + iK_im)(ψ_re + iψ_im) — four per axis per step. Same
operator conventions, Strang ordering and observables as
`split_step.evolve`/`ground_state`.

The dense products are plain large matrix products, which the JAX package
leaves to XLA outside any Pallas kernel; here they go to `torch.tensordot`.
`precision="highest"` runs them in full f32; `precision="default"` allows
TF32 for these products only, inside a scope that restores the global
setting before the call returns.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from gpe_tpu_torch.dynamics.split_step import (_axis_view, a2_pow, as_real,
                                               axis_coords, complex_dtype,
                                               observables, run_recorded,
                                               time_axis)

PRECISIONS = {"highest": "highest", "default": "high"}


def _axis_matrices(n: int, dx: float, bc: str, theta: float,
                   imaginary: bool, np_dtype):
    """Host-precomputed (f64, then cast) position-space 1D matrices:
    propagator K = T⁻¹ diag(e^{−θk²} or e^{−iθk²}) T and the analysis
    transform T itself (for spectral observables). Returns
    (K_re, K_im | None, T_re, T_im | None, k²_axis)."""
    if bc == "periodic":
        k = 2.0 * np.pi * np.fft.fftfreq(n, d=dx)
        T = np.fft.fft(np.eye(n), axis=0)          # T @ u = fft(u)
        D = np.exp((-theta if imaginary else -1j * theta) * k ** 2)
        K = np.fft.ifft(D[:, None] * T, axis=0)
        T_im = np.ascontiguousarray(T.imag).astype(np_dtype)
    elif bc == "dirichlet":
        j = np.arange(1, n + 1)
        S = np.sqrt(2.0 / (n + 1)) * np.sin(np.pi * np.outer(j, j) / (n + 1))
        k = np.pi * j / ((n + 1) * dx)
        D = np.exp((-theta if imaginary else -1j * theta) * k ** 2)
        K = S @ (D[:, None] * S)                   # S is involutory ortho
        T, T_im = S, None
    else:
        raise ValueError(f"unknown bc {bc!r}")
    K_re = np.ascontiguousarray(K.real).astype(np_dtype)
    K_im = (None if imaginary
            else np.ascontiguousarray(K.imag).astype(np_dtype))
    return K_re, K_im, np.ascontiguousarray(T.real).astype(np_dtype), \
        T_im, k ** 2


def _capply(Kr, Ki, ur, ui, axis):
    """(K_re + iK_im) @ (u_re + iu_im) contracted along `axis` of u — four
    real products (two when Ki is None: a real matrix)."""
    td = lambda K, u: torch.tensordot(K, u, dims=([1], [axis]))
    rr, ri = td(Kr, ur), td(Kr, ui)
    if Ki is None:
        vr, vi = rr, ri
    else:
        vr = rr - td(Ki, ui)
        vi = ri + td(Ki, ur)
    return torch.movedim(vr, 0, axis), torch.movedim(vi, 0, axis)


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Scope the f32 matmul precision ("highest": full f32, "default": TF32
    allowed) and restore the global setting on exit."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(PRECISIONS[precision])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _prepare(V, dx, dt, kinetic, bc, imaginary):
    """Per-axis propagators and analysis transforms on V's device, and the
    summed k² grid."""
    shape, dim = tuple(V.shape), V.ndim
    np_dtype = np.float64 if V.dtype == torch.float64 else np.float32
    t = lambda a: None if a is None else torch.as_tensor(a, device=V.device)
    mats = {"K_re": [], "K_im": [], "T_re": [], "T_im": []}
    k2 = 0
    for ax in range(dim):
        kr, ki, tr, ti, k2a = _axis_matrices(shape[ax], float(dx), bc,
                                             float(dt) * float(kinetic),
                                             imaginary, np_dtype)
        for key, a in zip(("K_re", "K_im", "T_re", "T_im"), (kr, ki, tr, ti)):
            mats[key].append(t(a))
        k2 = k2 + _axis_view(t(k2a.astype(np_dtype)), ax, dim)
    return mats, k2


def evolve_gemm(psi0, V, dx: float, dt: float, steps: int, gamma: float,
                kinetic: float = 0.5, p: float = 3.0, bc: str = "periodic",
                lb: float = 0.0, imaginary: bool = False,
                record_every: int = 1, precision: str = "highest",
                device=None):
    """split_step.evolve on the GEMM engine — the same contract (complex psi
    on the device; obs at t=0, every record_every steps, and the final time
    when record_every ∤ steps). `precision`: "highest" (full f32, the
    accuracy default) or "default" (TF32 products, scoped to this call)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    V = as_real(V, device)
    shape, dim = tuple(V.shape), V.ndim
    vol = dx ** dim
    pw = vol / V.numel() if bc == "periodic" else vol
    psi0 = torch.as_tensor(psi0, device=V.device).to(complex_dtype(V.dtype))
    pair = (psi0.real.contiguous(), psi0.imag.contiguous())
    mats, k2 = _prepare(V, dx, dt, kinetic, bc, imaginary)
    xs = [torch.as_tensor(x, dtype=V.dtype, device=V.device)
          for x in axis_coords(shape, dx, lb, bc)]

    def half_potential(ur, ui):
        theta = (0.5 * dt) * (V + gamma * a2_pow(ur * ur + ui * ui, p - 1.0))
        if imaginary:
            f = torch.exp(-theta)
            return ur * f, ui * f
        c, s = torch.cos(theta), torch.sin(theta)       # ψ ← ψ·e^{−iθ}
        return ur * c + ui * s, ui * c - ur * s

    def apply_axes(ur, ui, re, im):
        for ax in range(dim):
            ur, ui = _capply(mats[re][ax], mats[im][ax], ur, ui, ax)
        return ur, ui

    def step(c):
        ur, ui = half_potential(*c)
        ur, ui = apply_axes(ur, ui, "K_re", "K_im")
        ur, ui = half_potential(ur, ui)
        if imaginary:
            nrm = torch.sqrt(torch.sum(ur * ur + ui * ui) * vol)
            ur, ui = ur / nrm, ui / nrm
        return ur, ui

    def observe(c):
        ur, ui = c
        a2 = ur * ur + ui * ui
        cr, ci = apply_axes(ur, ui, "T_re", "T_im")
        ke = kinetic * torch.sum(k2 * (cr * cr + ci * ci)) * pw
        return observables(a2, ke, V, xs, gamma, p, vol,
                           torch.sum(a2_pow(a2, p + 1.0)))

    with matmul_precision(precision):
        (ur, ui), obs = run_recorded(step, pair, observe, int(steps),
                                     int(record_every))
    obs["t"] = time_axis(int(steps), int(record_every), dt)
    return torch.complex(ur, ui), obs


def ground_state_gemm(V, dx: float, gamma: float, kinetic: float = 0.5,
                      p: float = 3.0, bc: str = "periodic", lb: float = 0.0,
                      tau: float = 2e-3, steps: int = 40000,
                      tol: float = 1e-12, chunk: int = 500, psi0=None,
                      precision: str = "highest", device=None):
    """split_step.ground_state on the GEMM engine: renormalised
    imaginary-time flow with a host μ check per chunk (stop when μ moves
    less than tol). Returns (mu, psi)."""
    V = as_real(V, device)
    if psi0 is None:
        psi0 = torch.exp(-V / (2.0 * max(kinetic, 1e-6)))
        psi0 = psi0 / torch.sqrt(torch.sum(psi0 ** 2) * float(dx) ** V.ndim)
    psi, mu_prev = psi0, None
    for _ in range(max(1, int(steps) // int(chunk))):
        psi, obs = evolve_gemm(psi, V, dx, tau, int(chunk), gamma,
                               kinetic=kinetic, p=p, bc=bc, lb=lb,
                               imaginary=True, record_every=int(chunk),
                               precision=precision, device=V.device)
        mu = float(obs["mu"][-1])
        if mu_prev is not None and abs(mu - mu_prev) < tol:
            break
        mu_prev = mu
    return mu, psi
