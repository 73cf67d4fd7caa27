"""Real/imaginary-time TDGPE propagation by split-step spectral steps, port
of `gpe_tpu/dynamics/split_step.py` on `torch.fft`.

Propagates i∂ψ/∂t = −c·Δψ + Vψ + γ|ψ|^(p−1)ψ with Strang splitting (half
potential, full kinetic in spectral space, half potential), bc ∈ {periodic
FFT, Dirichlet DST-I built from the FFT of the odd extension}, in 1D/2D/3D.
`imaginary=True` is the renormalised gradient flow to the ground state.

ψ is complex64, or complex128 when V is float64: the dtype decides (JAX's
f64 comes only under `enable_x64`). The JAX `lax.scan`/`fori_loop` are a
host loop here; the observables (norm, energy, μ, per-axis centre and
width²) stay on the device every `record_every` steps and are fetched once
at the end. Entry points run on the CUDA card unless `device="cpu"`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gpe_tpu_torch.device import resolve_device


def _axis_view(k: torch.Tensor, axis: int, dim: int) -> torch.Tensor:
    return k.reshape([-1 if j == axis else 1 for j in range(dim)])


def complex_dtype(real_dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def _dst1_ortho(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Orthonormal DST-I along `axis` via the odd-extension FFT identity
    FFT(0, a, 0, −rev(a))_k = −2i·Σ_j a_j sin(πjk/(n+1)); involutory, valid
    for complex input."""
    n = a.shape[axis]
    cd = a.dtype if a.is_complex() else complex_dtype(a.dtype)
    a = a.to(cd)
    zshape = list(a.shape)
    zshape[axis] = 1
    z = torch.zeros(zshape, dtype=cd, device=a.device)
    ext = torch.cat([z, a, z, -torch.flip(a, [axis])], dim=axis)
    F = torch.fft.fft(ext, dim=axis).narrow(axis, 1, n)
    return F * (0.5j * math.sqrt(2.0 / (n + 1)))


def _full_k2(shape: tuple, dx: float, bc: str, real_dtype, device=None):
    """The Laplacian symbol k² of the bc's transform on the whole grid:
    (2π·fftfreq)² per axis for periodic, (πj/((n+1)dx))² (j = 1..n) for
    Dirichlet."""
    dim = len(shape)
    t = lambda a: torch.as_tensor(a, dtype=real_dtype, device=device)
    if bc == "periodic":
        ks = [t(2.0 * np.pi * np.fft.fftfreq(n, d=dx)) for n in shape]
    elif bc == "dirichlet":
        ks = [t(np.pi * np.arange(1, n + 1) / ((n + 1) * dx)) for n in shape]
    else:
        raise ValueError(f"unknown bc {bc!r}")
    return sum(_axis_view(k, i, dim) ** 2 for i, k in enumerate(ks))


def _spectral_ops(shape: tuple, dx: float, bc: str, real_dtype, device):
    """(to_spec, from_spec, k2, grad_sq_int): the transforms, the Laplacian
    symbol, and Σ_k k²·|coef|² times the Parseval weight (= ∫|∇ψ|²)."""
    dim = len(shape)
    vol = dx ** dim
    k2 = _full_k2(shape, dx, bc, real_dtype, device)
    if bc == "periodic":
        pw = vol / math.prod(shape)
        dims = tuple(range(dim))
        to_spec = lambda a: torch.fft.fftn(a, dim=dims)
        from_spec = lambda a: torch.fft.ifftn(a, dim=dims)
    else:
        pw = vol

        def to_spec(a):
            for ax in range(dim):
                a = _dst1_ortho(a, ax)
            return a
        from_spec = to_spec

    def grad_sq_int(coef):
        return torch.sum(k2 * (coef.real ** 2 + coef.imag ** 2)) * pw

    return to_spec, from_spec, k2, grad_sq_int


def axis_coords(shape: tuple, dx: float, lb: float, bc: str):
    """Per-axis sample coordinates: periodic x_j = lb + j·dx (j=0..n−1);
    Dirichlet interior x_j = lb + j·dx (j=1..n, box length (n+1)dx)."""
    off = 1 if bc == "dirichlet" else 0
    return [np.asarray(lb + (np.arange(n) + off) * dx) for n in shape]


def a2_pow(a2, q: float):
    """|ψ|^q from a2 = |ψ|²; an even integer q is a power of a2, with no
    square root."""
    if q == round(q) and q >= 0 and int(q) % 2 == 0:
        return a2 ** (int(q) // 2)
    return a2 ** (q / 2.0)


def abs_pow(psi, q: float):
    """|ψ|^q of a complex ψ."""
    return a2_pow(psi.real ** 2 + psi.imag ** 2, q)


def observables(a2, ke, V, xs, gamma, p, vol, inter, gsum=torch.sum):
    """norm, energy, μ, centre and width² (one 0-d/(dim,) tensor each) from
    |ψ|², the kinetic integral ke and Σ|ψ|^(p+1): the contract both engines
    share. `gsum` is the global sum: `torch.sum` on one device, a sum over
    the ranks' blocks when the grid is sharded (dynamics/sharded.py)."""
    dim = a2.ndim
    norm = gsum(a2) * vol
    pe = gsum(V * a2) * vol
    inter = inter * vol
    energy = (ke + pe + (2.0 * gamma / (p + 1.0)) * inter) / norm
    mu = (ke + pe + gamma * inter) / norm
    centers, widths = [], []
    for ax in range(dim):
        xa = _axis_view(xs[ax], ax, dim)
        c = gsum(xa * a2) * vol / norm
        centers.append(c)
        widths.append(gsum(xa * xa * a2) * vol / norm - c * c)
    return {"norm": norm, "energy": energy, "mu": mu,
            "center": torch.stack(centers), "width_sq": torch.stack(widths)}


def run_recorded(step, state, observe, steps: int, record_every: int):
    """Apply `step` `steps` times, observing at t=0, after every
    `record_every` steps and (when record_every ∤ steps) at the end; the
    observables are stacked on the device and fetched once."""
    recs = [observe(state)]
    n_rec, rem = divmod(steps, record_every)
    for _ in range(n_rec):
        for _ in range(record_every):
            state = step(state)
        recs.append(observe(state))
    for _ in range(rem):
        state = step(state)
    if rem:
        recs.append(observe(state))
    obs = {k: torch.stack([r[k] for r in recs]).cpu().numpy() for k in recs[0]}
    return state, obs


def time_axis(steps: int, record_every: int, dt: float) -> np.ndarray:
    n_rec, rem = divmod(steps, record_every)
    t = [0.0] + list((np.arange(1, n_rec + 1) * record_every) * float(dt))
    if rem:
        t.append(steps * float(dt))
    return np.asarray(t)


def as_real(V, device=None) -> torch.Tensor:
    """V as a real tensor on `device` (None → the CUDA card), keeping its
    float64/float32 type (other types become float32)."""
    V = torch.as_tensor(V, device=resolve_device(device))
    return V if V.dtype in (torch.float32, torch.float64) else V.float()


def evolve(psi0, V, dx: float, dt: float, steps: int, gamma: float,
           kinetic: float = 0.5, p: float = 3.0, bc: str = "periodic",
           lb: float = 0.0, imaginary: bool = False, record_every: int = 1,
           device=None):
    """Propagate ψ for `steps` Strang steps of size dt (imaginary=True: the
    τ-flow with per-step renormalisation). V: a real (n,), (nx, ny) or
    (nx, ny, nz) grid (same dx per axis); float64 selects complex128.

    Returns (psi_final, obs): psi a complex tensor on the device; obs numpy
    arrays of norm/energy/mu/center/width_sq at t=0, every `record_every`
    steps and (when record_every ∤ steps) the final time, and "t"."""
    V = as_real(V, device)
    shape, dim = tuple(V.shape), V.ndim
    cd = complex_dtype(V.dtype)
    psi = torch.as_tensor(psi0, device=V.device).to(cd)
    xs = [torch.as_tensor(x, dtype=V.dtype, device=V.device)
          for x in axis_coords(shape, dx, lb, bc)]
    to_spec, from_spec, k2, grad_sq_int = _spectral_ops(shape, dx, bc, V.dtype,
                                                        V.device)
    return evolve_core(psi, V, xs, dx ** dim, dt, steps, gamma, kinetic, p,
                       imaginary, record_every, to_spec=to_spec, from_spec=from_spec,
                       kin_prop=kinetic_factor(k2, dt, kinetic, imaginary),
                       grad_sq_int=grad_sq_int, gsum=torch.sum)


def kinetic_factor(k2, dt: float, kinetic: float, imaginary: bool):
    """The spectral Strang factor exp(−i·dt·c·k²), or exp(−dt·c·k²) in
    imaginary time, in the complex type of k²'s real type."""
    factor = -1.0 if imaginary else -1.0j
    return torch.exp((factor * dt * kinetic) * k2.to(complex_dtype(k2.dtype)))


def evolve_core(psi, V, xs, vol: float, dt: float, steps: int, gamma: float,
                kinetic: float, p: float, imaginary: bool, record_every: int, *,
                to_spec, from_spec, kin_prop, grad_sq_int, gsum):
    """The Strang loop of `evolve` on injected transforms and reductions: ψ
    (complex, on V's device; `vol` the cell volume dx^dim) stepped `steps`
    times and observed as `run_recorded` says; returns (ψ, obs) with obs's
    "t". The single-device (`evolve`) and the mesh-sharded
    (dynamics/sharded.py: slab transforms with all-to-all transposes) paths
    differ only in to_spec / from_spec, kin_prop (the Strang factor on
    to_spec's layout), grad_sq_int (Σ k²|coef|² times the Parseval weight)
    and gsum (the global sum: `torch.sum` on one device)."""
    cd = psi.dtype
    half = 0.5 * dt * (-1.0 if imaginary else -1.0j)

    def step(psi):
        psi = psi * torch.exp(half * (V + gamma * abs_pow(psi, p - 1.0)).to(cd))
        psi = from_spec(to_spec(psi) * kin_prop)
        psi = psi * torch.exp(half * (V + gamma * abs_pow(psi, p - 1.0)).to(cd))
        if imaginary:
            psi = psi / torch.sqrt(gsum(psi.real ** 2 + psi.imag ** 2) * vol)
        return psi

    def observe(psi):
        a2 = psi.real ** 2 + psi.imag ** 2
        ke = kinetic * grad_sq_int(to_spec(psi))
        return observables(a2, ke, V, xs, gamma, p, vol,
                           gsum(abs_pow(psi, p + 1.0)), gsum)

    psi, obs = run_recorded(step, psi, observe, int(steps), int(record_every))
    obs["t"] = time_axis(int(steps), int(record_every), dt)
    return psi, obs


def ground_state(V, dx: float, gamma: float, kinetic: float = 0.5,
                 p: float = 3.0, tau: float = 2e-3, steps: int = 20000,
                 tol: float = 1e-11, bc: str = "periodic", psi0=None,
                 chunk: int = 200, device=None):
    """Imaginary-time ground state on the device: chunks of `chunk` steps,
    μ checked on the host once per chunk (stop when it moves less than
    tol·max(1, |μ|)). Returns (mu, psi) with ∫|ψ|² = 1."""
    V = as_real(V, device)
    if psi0 is None:
        psi = torch.exp(-V / (2.0 * max(kinetic, 1e-6)))
        if bc == "dirichlet":
            for ax, n in enumerate(V.shape):
                env = torch.sin(torch.pi * torch.arange(1, n + 1, dtype=V.dtype,
                                                        device=V.device) / (n + 1))
                psi = psi * _axis_view(env, ax, V.ndim)
    else:
        psi = torch.as_tensor(psi0, device=V.device)
    psi = psi / torch.sqrt(torch.sum(torch.abs(psi) ** 2) * dx ** V.ndim)
    mu_prev = float("inf")
    for _ in range(max(1, steps // chunk)):
        psi, obs = evolve(psi, V, dx, tau, chunk, gamma, kinetic, p, bc=bc,
                          imaginary=True, record_every=chunk, device=V.device)
        mu = float(obs["mu"][-1])
        if abs(mu - mu_prev) < tol * max(1.0, abs(mu)):
            break
        mu_prev = mu
    return mu, psi
