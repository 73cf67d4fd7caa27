"""Spectral-flow distillation, port of `gpe_tpu/train/spectral_flow.py`:
imaginary-time flow targets on the collocation grid, distilled into the
network.

The split-step exponential map is unconditionally stable for any V:

    u ← normalize( e^(−τ(V+γ|u|^{p−1})/2) · F⁻¹ e^(−τc|k|²) F · e^(−τ(V+γ|u|^{p−1})/2) u )

1. Interleaved phase (the net's dtype, on its device): each outer step
   applies `flow_substeps` split-step blocks to the net's normalised grid
   values (torch.fft, or the DST-I per axis for bc="dirichlet"), reads the
   grid μ, and distills the target back into the net by `inner_steps` Adam
   steps on mean((normalize(net) − target)²). One Adam state serves every
   outer step of a solver call; on a CUDA device its steps replay a CUDA
   graph of one step, the target refilled in a static buffer each outer
   step (`pretrain.AdamSteps`).
2. Endgame (float64, on the device): the port's tolerance-converged
   imaginary-time oracle (`validate/imaginary_time.py`) with Richardson
   extrapolation in τ, started from the net's values; the last layer is
   divided by the net's norm c exactly; then `pretrain_to_base` fits the raw
   net to the f64 grid state (Adam, then optax's L-BFGS), and an optional
   LM polish minimises the mesh-free residual.

μ and the residual are reported from the net's analytic forward-Laplacian
derivatives (`report`), not from the grid. Three normalisations differ on
purpose, as in JAX: the flow's by √(Σu²·dx^d), the polish residual's by
√(Σu²·w), and `report`'s μ = Σu·Hu / Σu² with no weights.

bc="periodic" (FFT) for confining potentials whose states decay inside the
box; bc="dirichlet" (DST-I on the grid's interior points, the boundary rows
pinned to ψ = 0) for non-confining ones.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.ops.rayleigh import hamiltonian_apply
from gpe_tpu_torch.train.pretrain import AdamSteps, pretrain_to_base
from gpe_tpu_torch.train.problem import GPESpec
from gpe_tpu_torch.validate.imaginary_time import _dst1, imaginary_time_gpe


def dst1(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Orthonormal DST-I along `axis` by the FFT of the odd extension
    (involutory; matches scipy.fft.dst(type=1, norm="ortho")). It
    diagonalises the Dirichlet Laplacian on m interior points of a box of
    length (m+1)·dx, modes k_j = πj/L."""
    return _dst1(a, axis)


class FlowResult(NamedTuple):
    params: any
    mu: float            # μ from the net's analytic derivatives (mesh-free)
    mu_grid: float       # μ of the f64 grid flow (spectral oracle, Richardson)
    pde_loss: float      # mean residual² from analytic derivatives
    mu_history: np.ndarray
    fit_history: np.ndarray
    target: np.ndarray   # converged f64 grid ground state (flat, ∫ψ²=1)
    seconds: dict = None  # {"interleave", "endgame", "distill", "polish", "report"}


def make_spectral_flow_solver(spec: GPESpec, outer_steps: int = 150,
                              inner_steps: int = 80, tau: float = 2e-2,
                              inner_lr: float = 2e-3, flow_substeps: int = 4,
                              final_inner_steps: int = 2000,
                              final_lbfgs_steps: int = 200,
                              endgame_tau: float = 4e-3,
                              endgame_steps: int = 60000,
                              endgame_tol: float = 1e-13,
                              polish_steps: int = 0,
                              polish_cg_iters: int = 60,
                              bc: str = "periodic"):
    """solver(params, batch, gamma) → FlowResult. Vanilla ansatz (u = net).

    batch must be a full uniform grid from make_batch(spec, mode); the
    solver runs on its device. With bc="dirichlet" the flow runs on the
    grid's interior points by DST-I (boundary rows held at ψ = 0 in every
    distillation target). `solver.report(params, batch, gamma)` → (μ, mean
    residual²) of the normalised net."""
    if bc not in ("periodic", "dirichlet"):
        raise ValueError(f"unknown bc {bc!r}")
    n_side = spec.n_points
    dim = spec.dim
    act = spec.activation
    dx = (spec.ub - spec.lb) / (n_side - 1)
    vol = dx ** dim
    grid = (n_side,) * dim
    core = (slice(1, -1),) * dim
    axes = tuple(range(dim))

    def _bcast(k, axis):            # per-axis symbol → dim-D broadcast shape
        return k.reshape([-1 if j == axis else 1 for j in range(dim)])

    def _symbols(dtype, device):
        """(k², the kinetic propagator) in the net's dtype on its device."""
        if bc == "periodic":
            k1 = 2.0 * math.pi * torch.fft.fftfreq(n_side, d=dx, dtype=dtype,
                                                    device=device)
        else:
            m = n_side - 2          # interior points; box length L = (m+1)·dx
            k1 = (math.pi * torch.arange(1, m + 1, device=device).to(dtype)
                  / ((m + 1) * dx))
        k2 = sum(_bcast(k1, ax) ** 2 for ax in range(dim))
        return k2, torch.exp(-tau * spec.kinetic * k2)

    def _normalize(u):
        return u / torch.sqrt(torch.sum(u * u) * vol + 1e-30)

    def _to_spec(g):
        if bc == "periodic":
            return torch.fft.fftn(g, dim=axes)
        for ax in axes:
            g = dst1(g, ax)
        return g

    def _from_spec(a):
        if bc == "periodic":
            return torch.fft.ifftn(a, dim=axes).real
        for ax in axes:
            a = dst1(a, ax)
        return a

    def _flow_step(u, V, gamma, kin_prop):
        """One block of imaginary-time substeps on the grid values; takes and
        returns the full grid (dirichlet: boundary re-pinned to 0)."""
        g = u.reshape(grid)
        Vg = V.reshape(grid)
        if bc == "dirichlet":
            g, Vg = g[core], Vg[core]
        for _ in range(flow_substeps):
            g = g * torch.exp(-0.5 * tau * (Vg + gamma * torch.abs(g) ** (spec.p - 1.0)))
            g = _from_spec(_to_spec(g) * kin_prop)
            g = g * torch.exp(-0.5 * tau * (Vg + gamma * torch.abs(g) ** (spec.p - 1.0)))
            g = _normalize(g.reshape(-1)).reshape(g.shape)
        if bc == "dirichlet":
            full = torch.zeros(grid, dtype=g.dtype, device=g.device)
            full[core] = g
            g = full
        return g.reshape(-1)

    def _grid_mu(u, V, gamma, k2):
        g = u.reshape(grid)
        if bc == "dirichlet":
            g = g[core]
            V = V.reshape(grid)[core].reshape(-1)
        lap = _from_spec(-k2 * _to_spec(g)).reshape(-1)
        hu = hamiltonian_apply(g.reshape(-1), lap, V, gamma, spec.p, spec.kinetic,
                               spec.nonlinearity)
        return torch.sum(g.reshape(-1) * hu) * vol

    def interleave(params, batch, gamma):
        """outer_steps × (flow block, grid μ, inner_steps Adam steps):
        (params, the grid μ and the last inner step's fit loss of each
        outer step, as numpy)."""
        x, V = batch["x"], batch["V"]
        k2, kin_prop = _symbols(x.dtype, x.device)
        leaves = [t.detach().clone().requires_grad_(True) for pair in params for t in pair]
        pairs = tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))
        target = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        adam = AdamSteps(lambda: torch.mean((_normalize(mlp.mlp_apply(pairs, x, act))
                                             - target) ** 2),
                         leaves, inner_lr, graph=x.is_cuda)
        mus, fits = [], []
        for _ in range(outer_steps):
            with torch.no_grad():
                v = mlp.mlp_apply(pairs, x, act)
                target.copy_(_flow_step(_normalize(v), V, gamma, kin_prop))
                mus.append(_grid_mu(target, V, gamma, k2))
            last = adam.run(inner_steps)
            fits.append(last.clone() if last is not None
                        else torch.full_like(target[0], float("nan")))
        out = tuple((w.detach(), b.detach()) for w, b in pairs)
        if not mus:
            return out, np.zeros(0), np.zeros(0)
        return out, torch.stack(mus).cpu().numpy(), torch.stack(fits).cpu().numpy()

    def report(params, batch, gamma):
        """Mesh-free (μ, mean residual²) of the normalised net from its
        analytic derivatives, as device tensors."""
        with torch.no_grad():
            n = mlp.mlp_vgl(params, batch["x"], act)
            norm = torch.sqrt(torch.sum(n.value ** 2) * vol + 1e-30)
            u = n.value / norm
            lap = n.lap / norm
            hu = hamiltonian_apply(u, lap, batch["V"], gamma, spec.p, spec.kinetic,
                                   spec.nonlinearity)
            mu = torch.sum(u * hu) / (torch.sum(u * u) + 1e-12)
            r = hu - mu * u
            return mu, torch.mean(r * r)

    lm_cache = {}

    def _polish(params, batch, gamma):
        from gpe_tpu_torch.train.gauss_newton import make_lm_solver

        def residuals(p, b, g, s):
            n = mlp.mlp_vgl(p, b["x"], act)
            norm = torch.sqrt(torch.sum(n.value ** 2 * b["w"]) + 1e-30)
            u = n.value / norm
            lap = n.lap / norm
            hu = hamiltonian_apply(u, lap, b["V"], g, spec.p, spec.kinetic,
                                   spec.nonlinearity)
            mu = torch.sum(u * hu) / (torch.sum(u * u) + 1e-12)
            return (hu - mu * u) / math.sqrt(float(u.shape[0]))

        if "lm" not in lm_cache:
            lm_cache["lm"] = make_lm_solver(residuals, params, steps=polish_steps,
                                            cg_iters=polish_cg_iters)
        return lm_cache["lm"](params, batch, gamma, 1.0).params

    def _sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def solver(params, batch, gamma) -> FlowResult:
        pin_full_f32()
        x = batch["x"]
        dev = x.device
        # γ reaches the interleave and the report rounded to f32, the f64
        # endgame as the Python float
        g32 = torch.tensor(float(np.float32(gamma)), dtype=x.dtype, device=dev)
        seconds = {}
        t0 = time.perf_counter()
        params, mus, fits = interleave(params, batch, g32)
        _sync(dev)
        seconds["interleave"] = time.perf_counter() - t0

        # Endgame: tolerance-converged float64 flow from the net's values,
        # Richardson-extrapolated in τ (removes the O(τ) renormalisation bias).
        t0 = time.perf_counter()
        with torch.no_grad():
            v = mlp.mlp_apply(params, x, act).double()
        c = float(torch.sqrt(torch.sum(v * v) * vol))
        u0 = (v / c).reshape(grid)
        V64 = batch["V"].double().reshape(grid)
        if bc == "dirichlet":
            u0i = u0[core].clone()
            u0i = u0i / torch.sqrt(torch.sum(u0i * u0i) * vol)
            mu_grid, psi_i = imaginary_time_gpe(
                V64[core], dx, float(gamma), kinetic=spec.kinetic, p=spec.p,
                tau=endgame_tau, steps=endgame_steps, tol=endgame_tol, psi0=u0i,
                richardson=True, bc="dirichlet", device=dev)
            psi = torch.zeros(grid, dtype=torch.float64, device=dev)
            psi[core] = psi_i
        else:
            mu_grid, psi = imaginary_time_gpe(
                V64, dx, float(gamma), kinetic=spec.kinetic, p=spec.p,
                tau=endgame_tau, steps=endgame_steps, tol=endgame_tol, psi0=u0,
                richardson=True, device=dev)
        target = psi.reshape(-1).to(x.dtype)
        seconds["endgame"] = time.perf_counter() - t0

        # The interleaved phase fits normalize(out), leaving the net's raw
        # scale arbitrary: divide the linear output layer by ‖out‖ exactly,
        # then fit the raw output to the normalised f64 target (Adam →
        # L-BFGS), which also pins the net's own scale to ∫ψ² = 1.
        t0 = time.perf_counter()
        w_last, b_last = params[-1]
        params = tuple(params[:-1]) + ((w_last / c, b_last / c),)
        params, final_mse = pretrain_to_base(
            params, x, target, act, epochs=final_inner_steps,
            lbfgs_steps=final_lbfgs_steps)
        _sync(dev)
        seconds["distill"] = time.perf_counter() - t0

        # Optional Levenberg–Marquardt polish of the mesh-free PDE residual
        # of the normalised net (no grid target involved).
        t0 = time.perf_counter()
        if polish_steps > 0:
            params = _polish(params, batch, g32)
        _sync(dev)
        seconds["polish"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        mu, pde = report(params, batch, g32)
        mu, pde = float(mu), float(pde)
        seconds["report"] = time.perf_counter() - t0

        mu_hist = np.concatenate([mus, [mu_grid]])
        fit_hist = np.concatenate([fits, [final_mse]])
        return FlowResult(params, mu, float(mu_grid), pde, mu_hist, fit_hist,
                          psi.reshape(-1).cpu().numpy(), seconds)

    solver.report = report
    return solver
