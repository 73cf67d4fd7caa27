"""Finite-difference ground-truth solvers for validation, port of
`gpe_tpu/validate/fdm.py`.

The 1D dense solves (`linear_eigensolve_1d`, `solve_gpe_scf_1d`) run as
float64 `torch.linalg.eigh` on the device (None → the CUDA card). The 2D SCF
loop (`solve_gpe_scf_2d`) and the excited-state Newton continuation
(`solve_gpe_excited_1d`) keep scipy's sparse `eigsh`/`splu` shift-invert on
the host, as the JAX package does: torch has no sparse shift-invert
eigensolver. They take V as numpy or a tensor and return ψ as a float64
tensor on the device. These are validation oracles, not training-path
components.
"""
from __future__ import annotations

import numpy as np
import torch

from gpe_tpu_torch.device import resolve_device
from gpe_tpu_torch.validate.imaginary_time import F64, as_f64


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(np.float64)
    return np.asarray(a, dtype=np.float64)


def _lap_1d(n: int, dx: float, device) -> torch.Tensor:
    """Dense 1D second-difference operator with Dirichlet BCs."""
    off = torch.ones(n - 1, dtype=F64, device=device)
    L = (torch.diag(torch.full((n,), -2.0, dtype=F64, device=device))
         + torch.diag(off, 1) + torch.diag(off, -1))
    return L / (dx * dx)


def linear_eigensolve_1d(V, dx: float, k: int = 6, kinetic: float = 1.0,
                         device=None):
    """Lowest-k eigenpairs of −c·ψ″ + Vψ = μψ on a uniform Dirichlet grid.

    Returns (mus (k,), psis (n, k)) as float64 tensors on `device`, ψ
    normalized to ∫|ψ|²dx = 1 (each eigenvector's sign is eigh's)."""
    dev = resolve_device(device)
    V = as_f64(V, dev)
    H = -kinetic * _lap_1d(V.shape[0], dx, dev) + torch.diag(V)
    mus, vecs = torch.linalg.eigh(H)
    return mus[:k], vecs[:, :k] / np.sqrt(dx)     # eigh vectors are l2-normalized


def solve_gpe_scf_1d(V, dx: float, gamma: float, kinetic: float = 1.0,
                     tol: float = 1e-10, max_iter: int = 200, mixing: float = 0.5,
                     device=None):
    """1D GPE ground state by SCF iteration (dense eigh on `device`).

    Returns (mu, psi) with ∫|ψ|²dx = 1 and H[ψ]ψ = μψ converged."""
    dev = resolve_device(device)
    V = as_f64(V, dev)
    n = V.shape[0]
    L = _lap_1d(n, dx, dev)
    psi = torch.full((n,), 1.0 / np.sqrt(n * dx), dtype=F64, device=dev)
    for _ in range(max_iter):
        H = -kinetic * L + torch.diag(V + gamma * psi * psi)
        vecs = torch.linalg.eigh(H)[1]
        new = vecs[:, 0] / np.sqrt(dx)
        if new[torch.argmax(new.abs())] < 0:
            new = -new
        new = mixing * new + (1.0 - mixing) * psi
        new = new / torch.sqrt(torch.sum(new * new) * dx)
        delta = float(torch.linalg.vector_norm(new - psi)) * np.sqrt(dx)
        psi = new
        if delta < tol:
            break
    # report μ of the *converged* density (unmixed Hamiltonian)
    H = -kinetic * L + torch.diag(V + gamma * psi * psi)
    return float(torch.linalg.eigvalsh(H)[0]), psi


def solve_gpe_scf_2d(V, dx: float, gamma: float, kinetic: float = 1.0,
                     tol: float = 1e-8, max_iter: int = 100, mixing: float = 0.5,
                     device=None):
    """2D GPE ground state by SCF + sparse eigsh on the host (the
    reference's method); ψ returned on `device`.

    V: (nx, ny) potential on a uniform grid with spacing dx in both axes.
    Returns (mu, psi (nx, ny)) with ∬|ψ|²dxdy = 1. As in the JAX package,
    ARPACK starts from its own vector, so results agree between runs to the
    SCF's tol, not to the bit."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh

    dev = resolve_device(device)
    V = _host(V)
    nx, ny = V.shape
    ex = np.ones(nx)
    ey = np.ones(ny)
    Dxx = sp.diags([ex[:-1], -2 * ex, ex[:-1]], [-1, 0, 1]) / (dx * dx)
    Dyy = sp.diags([ey[:-1], -2 * ey, ey[:-1]], [-1, 0, 1]) / (dx * dx)
    L = sp.kron(Dxx, sp.eye(ny)) + sp.kron(sp.eye(nx), Dyy)

    area = dx * dx
    psi = np.ones(nx * ny)
    psi /= np.sqrt(np.sum(psi * psi) * area)
    for _ in range(max_iter):
        H = -kinetic * L + sp.diags(V.ravel() + gamma * psi * psi)
        _, vecs = eigsh(H, k=1, which="SA")
        new = vecs[:, 0]
        if new[np.argmax(np.abs(new))] < 0:
            new = -new
        new /= np.sqrt(np.sum(new * new) * area)
        new = mixing * new + (1.0 - mixing) * psi
        new /= np.sqrt(np.sum(new * new) * area)
        delta = np.linalg.norm(new - psi) * np.sqrt(area)
        psi = new
        if delta < tol:
            break
    H = -kinetic * L + sp.diags(V.ravel() + gamma * psi * psi)
    mu = float(eigsh(H, k=1, which="SA", return_eigenvectors=False)[0])
    return mu, torch.as_tensor(psi.reshape(nx, ny), dtype=F64, device=dev)


def _lap_1d_sparse4(n: int, dx: float):
    """Sparse 4th-order 1D Laplacian (−1/12, 4/3, −5/2, 4/3, −1/12)/dx² with
    Dirichlet BCs. Boundary rows use the 3-point stencil: the truncated
    5-point stencil at a Dirichlet wall assumes ψ(−dx)=0, which degrades the
    eigenvalue to first order in dx wherever ψ′(wall) ≠ 0."""
    from scipy import sparse
    main = np.full(n, -2.5)
    off1 = np.full(n - 1, 4.0 / 3.0)
    off2 = np.full(n - 2, -1.0 / 12.0)
    L = sparse.diags([off2, off1, main, off1, off2], [-2, -1, 0, 1, 2]).tolil()
    for i in (0, n - 1):
        L[i, :] = 0.0
        L[i, i] = -2.0
        if i > 0:
            L[i, i - 1] = 1.0
        if i < n - 1:
            L[i, i + 1] = 1.0
    return (L / (dx * dx)).tocsc()


def solve_gpe_excited_1d(V, dx: float, gamma: float, mode: int = 0,
                         kinetic: float = 1.0, p: float = 3.0,
                         tol: float = 1e-11, max_newton: int = 50,
                         gamma_step: float = 5.0,
                         nonlinearity: str = "abs_power", device=None):
    """1D GPE EXCITED state (mode = node count) by Newton continuation on the
    4th-order sparse discretization of the nonlinear eigenproblem

        F(ψ, μ) = [ −c·Lψ + Vψ + γ·𝒩(ψ) − μψ ;  ∫ψ²dx − 1 ] = 0,

    warm-started from the linear eigenpair (shift-invert eigsh) and ramped
    in γ, on the host; ψ returned on `device`. Returns (mu, psi),
    ∫|ψ|²dx = 1."""
    from scipy.sparse import bmat, csc_matrix, diags
    from scipy.sparse.linalg import eigsh, splu

    dev = resolve_device(device)
    V = _host(V)
    # Solve on INTERIOR points only: the wall values are constrained to zero
    n_full = V.shape[0]
    V = V[1:-1]
    n = V.shape[0]
    L = _lap_1d_sparse4(n, dx)
    A = -kinetic * L + diags(V)          # linear part, constant along the ramp

    def _embed(u):
        full = np.zeros(n_full)
        full[1:-1] = u
        full = full / np.sqrt(np.sum(full * full) * dx)
        return torch.as_tensor(full, dtype=F64, device=dev)

    # v0 MUST be fixed and generic: eigsh otherwise starts from numpy's
    # GLOBAL rng, so results depend on whatever ran before; k+2 extra Krylov
    # targets guard against a missed eigenvalue in the cluster
    sigma = float(np.min(V)) - 1.0
    v0 = np.random.default_rng(12345).standard_normal(n)
    mus, vecs = eigsh(A.tocsc(), k=mode + 3, sigma=sigma, which="LM", v0=v0)
    order = np.argsort(mus)
    psi = vecs[:, order[mode]] / np.sqrt(dx)
    if psi[np.argmax(np.abs(psi))] < 0:
        psi = -psi
    mu = float(mus[order[mode]])
    if gamma == 0.0:
        return mu, _embed(psi)

    def nonlin(u, g):
        if nonlinearity == "power":
            return g * u**p, p * g * u ** (p - 1.0)      # d/du uᵖ = p·u^{p−1}
        return g * np.abs(u) ** (p - 1.0) * u, p * g * np.abs(u) ** (p - 1.0)

    n_steps = max(1, int(np.ceil(abs(gamma) / gamma_step)))
    for g in np.linspace(gamma / n_steps, gamma, n_steps):
        for _ in range(max_newton):
            Nu, dNu = nonlin(psi, g)
            r = A @ psi + Nu - mu * psi
            c = np.sum(psi * psi) * dx - 1.0
            res = np.sqrt(np.sum(r * r) * dx) + abs(c)
            if res < tol:
                break
            J = A + diags(dNu - mu)
            B = bmat([[J, csc_matrix(-psi[:, None])],
                      [csc_matrix(2.0 * dx * psi[None, :]), None]], format="csc")
            delta = splu(B).solve(np.concatenate([-r, [-c]]))
            psi = psi + delta[:n]
            mu = mu + delta[n]
    return float(mu), _embed(psi)
