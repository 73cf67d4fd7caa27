"""Rotating-frame TDGPE propagation by the Bao–Wang ADI split step, port of
`gpe_tpu/dynamics/rotating_step.py` on `torch.fft`.

Propagates complex ψ(x, y) in the frame rotating at Ω,

    i ∂ψ/∂t = [ −c·Δ + V + γ|ψ|^(p−1) − Ω·L_z ] ψ,   L_z = −i(x∂_y − y∂_x),

grouping the rotation with the kinetic terms so that every factor is
exactly exponentiable (Bao & Wang, J. Comput. Phys. 217 (2006) 612):

    A = c·p_x² + Ω·y·p_x   (diagonal after the FFT in x: symbol on (k_x, y)),
    B = c·p_y² − Ω·x·p_y   (diagonal after the FFT in y: symbol on (x, k_y)),
    C = V + γ|ψ|^(p−1)     (diagonal in position),

Strang-composed e^{−iτC/2} e^{−iτA/2} e^{−iτB} e^{−iτA/2} e^{−iτC/2}: the
operator order of the float64 oracle `validate/rotating.py`, so the two agree
step for step. `imaginary=True` is the renormalised gradient flow to the
rotating-frame stationary states (vortex states above the nucleation Ω).
Periodic boundaries only: the first-order symbols Ω·y·k_x, Ω·x·k_y are not
diagonal in the DST-I. A float64 V selects complex128. The JAX scan is a host
loop (`split_step.run_recorded`): observables stay on the device and are
fetched once. Entry points run on the CUDA card unless `device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch

from gpe_tpu_torch.dynamics.split_step import (abs_pow, as_real, axis_coords,
                                               complex_dtype, run_recorded,
                                               time_axis)


def evolve_rotating(psi0, V, dx: float, dt: float, steps: int, gamma: float,
                    omega: float, kinetic: float = 0.5, p: float = 3.0,
                    lb: float = 0.0, imaginary: bool = False,
                    record_every: int = 1, device=None):
    """Propagate complex ψ(x, y) in the frame rotating at Ω for `steps`
    Strang ADI steps of size dt (imaginary=True: the renormalised flow).
    V: a real (nx, ny) grid, the same dx on both axes, a periodic box from
    lb. Returns (psi_final, obs): ψ a complex tensor on the device; obs numpy
    arrays of norm, energy, μ, lz (⟨L_z⟩ per particle), center and width_sq
    at t = 0, every `record_every` steps and (when record_every ∤ steps) at
    the final time, and "t"."""
    V = as_real(V, device)
    if V.ndim != 2:
        raise ValueError("rotating frame is 2D: V must be (nx, ny)")
    rd, cd, dev = V.dtype, complex_dtype(V.dtype), V.device
    n0, n1 = V.shape
    vol = dx * dx
    x, y = (torch.as_tensor(c, dtype=rd, device=dev)
            for c in axis_coords((n0, n1), dx, lb, "periodic"))
    t = lambda a: torch.as_tensor(a, dtype=rd, device=dev)
    kx = t(2.0 * np.pi * np.fft.fftfreq(n0, d=dx))
    ky = t(2.0 * np.pi * np.fft.fftfreq(n1, d=dx))
    symb_A = kinetic * kx[:, None] ** 2 + omega * y[None, :] * kx[:, None]
    symb_B = kinetic * ky[None, :] ** 2 - omega * x[:, None] * ky[None, :]
    factor = -1.0 if imaginary else -1.0j
    expA_half = torch.exp((0.5 * dt * factor) * symb_A.to(cd))
    expB = torch.exp((dt * factor) * symb_B.to(cd))
    half = 0.5 * dt * factor
    psi = torch.as_tensor(psi0, device=dev).to(cd)

    def step(psi):
        psi = psi * torch.exp(half * (V + gamma * abs_pow(psi, p - 1.0)).to(cd))
        psi = torch.fft.ifft(torch.fft.fft(psi, dim=0) * expA_half, dim=0)
        psi = torch.fft.ifft(torch.fft.fft(psi, dim=1) * expB, dim=1)
        psi = torch.fft.ifft(torch.fft.fft(psi, dim=0) * expA_half, dim=0)
        psi = psi * torch.exp(half * (V + gamma * abs_pow(psi, p - 1.0)).to(cd))
        if imaginary:
            psi = psi / torch.sqrt(torch.sum(psi.real ** 2 + psi.imag ** 2) * vol)
        return psi

    def observe(psi):
        a2 = psi.real ** 2 + psi.imag ** 2
        norm = torch.sum(a2) * vol
        gx = torch.fft.ifft(1j * kx[:, None] * torch.fft.fft(psi, dim=0), dim=0)
        gy = torch.fft.ifft(1j * ky[None, :] * torch.fft.fft(psi, dim=1), dim=1)
        grad2 = gx.real ** 2 + gx.imag ** 2 + gy.real ** 2 + gy.imag ** 2
        lz_dens = torch.real(torch.conj(psi) * (-1j) * (x[:, None] * gy - y[None, :] * gx))
        ke = kinetic * torch.sum(grad2) * vol
        pe = torch.sum(V * a2) * vol
        inter = torch.sum(abs_pow(psi, p + 1.0)) * vol
        lz = torch.sum(lz_dens) * vol
        cx = torch.sum(x[:, None] * a2) * vol / norm
        cy = torch.sum(y[None, :] * a2) * vol / norm
        wx = torch.sum(x[:, None] ** 2 * a2) * vol / norm - cx * cx
        wy = torch.sum(y[None, :] ** 2 * a2) * vol / norm - cy * cy
        return {"norm": norm,
                "energy": (ke + pe + (2.0 * gamma / (p + 1.0)) * inter - omega * lz) / norm,
                "mu": (ke + pe + gamma * inter - omega * lz) / norm,
                "lz": lz / norm, "center": torch.stack([cx, cy]),
                "width_sq": torch.stack([wx, wy])}

    psi, obs = run_recorded(step, psi, observe, int(steps), int(record_every))
    obs["t"] = time_axis(int(steps), int(record_every), dt)
    return psi, obs


def rotating_ground_state(V, dx: float, gamma: float, omega: float,
                          kinetic: float = 0.5, p: float = 3.0,
                          tau: float = 2e-3, steps: int = 40000,
                          tol: float = 1e-11, lb: float = 0.0, psi0=None,
                          seed_vortex: bool = True, chunk: int = 200,
                          device=None):
    """Rotating-frame ground state on the device: chunks of `chunk`
    imaginary-time steps, μ checked on the host once a chunk (stop when it
    moves less than tol·max(1, |μ|)). The default seed, on the host, is a
    Gaussian, times a displaced vortex (x − 0.3) + i(y + 0.2) plus 1%
    complex noise of numpy's default_rng(0) when seed_vortex and Ω > 0 (the
    JAX package's draw); pass psi0 (or seed_vortex=False) for the
    zero-circulation branch. Returns (mu, psi, lz) with ∫|ψ|² = 1."""
    V = as_real(V, device)
    if psi0 is None:
        x0, x1 = axis_coords(tuple(V.shape), dx, lb, "periodic")
        X, Y = np.meshgrid(x0, x1, indexing="ij")
        psi = np.exp(-(X ** 2 + Y ** 2) / 2.0).astype(complex)
        if seed_vortex and omega > 0:
            rng = np.random.default_rng(0)
            psi = psi * ((X - 0.3) + 1j * (Y + 0.2))
            psi += 0.01 * (rng.standard_normal(psi.shape)
                           + 1j * rng.standard_normal(psi.shape)) * np.abs(psi).max()
        psi = torch.as_tensor(psi, device=V.device)
    else:
        psi = torch.as_tensor(psi0, device=V.device)
    psi = psi / torch.sqrt(torch.sum(torch.abs(psi) ** 2) * dx * dx)
    mu_prev = float("inf")
    obs = None
    for _ in range(max(1, steps // chunk)):
        psi, obs = evolve_rotating(psi, V, dx, tau, chunk, gamma, omega, kinetic, p,
                                   lb=lb, imaginary=True, record_every=chunk,
                                   device=V.device)
        mu = float(obs["mu"][-1])
        if abs(mu - mu_prev) < tol * max(1.0, abs(mu)):
            break
        mu_prev = mu
    return float(obs["mu"][-1]), psi, float(obs["lz"][-1])
