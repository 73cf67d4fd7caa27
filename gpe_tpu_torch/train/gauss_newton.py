"""Matrix-free Levenberg–Marquardt for PINN residuals, port of
`gpe_tpu/train/gauss_newton.py` (`make_gpe_residual_fn`, `make_lm_solver`).

    (JᵀJ + λ·curv·I) δ = Jᵀr,   θ ← θ − δ

with J the Jacobian of the full residual vector. JᵀJ·v = vjp(jvp(v)) with
torch.func on a flat parameter vector — no J is formed. The CG solve follows
jax.scipy.sparse.linalg.cg: x₀ = 0, stop when ‖r‖² ≤ (1e-5)²‖b‖² or after
`cg_iters` iterations. ‖r‖² of the residual equals the fit() total loss.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jvp, vjp

from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.ops.rayleigh import hamiltonian_apply
from gpe_tpu_torch.train.problem import GPESpec, spec_ansatz


def make_gpe_residual_fn(spec: GPESpec) -> Callable:
    """residuals(params, batch, gamma, scale) -> 1-D residual vector whose
    sum of squares equals the fit() total loss (same ansatz composition as
    make_terms_fn)."""
    a = spec_ansatz(spec)

    def residuals(params, batch, gamma, scale):
        n = a.vgl(params, batch["x"], 1.0)
        u = scale * n.value
        lap = scale * n.lap
        bv = a.value(params, batch["bx"], 1.0) * scale
        if spec.use_perturbation:
            u = batch["base_val"] + u
            lap = batch["base_lap"] + lap
            bv = batch["base_bval"] + bv
        hu = hamiltonian_apply(u, lap, batch["V"], gamma, spec.p, spec.kinetic,
                               spec.nonlinearity)
        mu = torch.sum(u * hu) / (torch.sum(u * u) + 1e-12)
        r_pde = (hu - mu * u) / math.sqrt(float(u.shape[0]))
        r_bc = math.sqrt(spec.bc_weight / float(bv.shape[0])) * bv
        r_norm = math.sqrt(spec.norm_weight) * (torch.sum(u * u * batch["w"]) - 1.0)
        return torch.cat([r_pde, r_bc, r_norm[None]])

    return residuals


class LMResult(NamedTuple):
    params: tuple
    loss: float
    loss_history: np.ndarray
    lam_history: np.ndarray


def cg(matvec: Callable, b: torch.Tensor, maxiter: int,
       tol: float = 1e-5) -> torch.Tensor:
    """Conjugate gradients from x₀ = 0 with jax.scipy.sparse.linalg.cg's
    stopping rule (relative tol, atol 0)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    gamma = torch.dot(r, r)
    atol2 = float(tol * tol * gamma)
    k = 0
    while k < maxiter and float(gamma) > atol2:
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = torch.dot(r, r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x


def make_lm_solver(residual_fn: Callable, params_template, steps: int = 100,
                   cg_iters: int = 50, lam0: float = 1e-2, lam_min: float = 1e-9,
                   lam_max: float = 1e6) -> Callable:
    """solver(params, batch, gamma, scale) -> LMResult: `steps` LM steps
    with Marquardt damping λ·curv (curv = ‖J ĝ‖², ĝ the unit gradient) and
    accept/reject trust-region updates of λ."""
    shapes = [t.shape for pair in params_template for t in pair]
    sizes = [int(np.prod(s)) for s in shapes]

    def unravel(theta):
        leaves = [c.view(s) for c, s in zip(torch.split(theta, sizes), shapes)]
        return tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))

    def solver(params, batch, gamma, scale) -> LMResult:
        pin_full_f32()
        theta = torch.cat([t.detach().reshape(-1) for pair in params for t in pair])
        lam = lam0

        def rflat(th):
            return residual_fn(unravel(th), batch, gamma, scale)

        losses, lams = [], []
        for _ in range(steps):
            r, vjp_fn = vjp(rflat, theta)
            loss = torch.sum(r * r)
            g = vjp_fn(r)[0]
            ghat = g / (torch.linalg.vector_norm(g) + 1e-30)
            _, jg = jvp(rflat, (theta,), (ghat,))
            curv = torch.sum(jg * jg) + 1e-30

            def matvec(v):
                _, jv = jvp(rflat, (theta,), (v,))
                return vjp_fn(jv)[0] + lam * curv * v

            delta = cg(matvec, g, cg_iters)
            theta_new = theta - delta
            r_new = rflat(theta_new)
            loss_new = torch.sum(r_new * r_new)
            accept = bool((loss_new < loss) & torch.isfinite(loss_new))
            if accept:
                theta = theta_new
            lam = min(max(lam * 0.5 if accept else lam * 4.0, lam_min), lam_max)
            losses.append(torch.minimum(loss, loss_new).detach())
            lams.append(lam)
        loss_hist = torch.stack(losses).cpu().numpy()
        return LMResult(tuple((w.detach(), b.detach()) for w, b in unravel(theta)),
                        float(loss_hist[-1]), loss_hist, np.asarray(lams))

    return solver
