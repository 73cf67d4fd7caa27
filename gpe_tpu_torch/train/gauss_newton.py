"""Matrix-free Levenberg–Marquardt for PINN residuals, port of
`gpe_tpu/train/gauss_newton.py` (`make_gpe_residual_fn`, `make_lm_solver`,
`lm_polish_x64`).

    (JᵀJ + λ·curv·I) δ = Jᵀr,   θ ← θ − δ

with J the Jacobian of the full residual vector. JᵀJ·v = vjp(jvp(v)) with
torch.func on a flat parameter vector — no J is formed. The CG solve follows
jax.scipy.sparse.linalg.cg: x₀ = 0, stop when ‖r‖² ≤ (1e-5)²‖b‖² or after
`cg_iters` iterations. ‖r‖² of the residual equals the fit() total loss.
On a CUDA device each CG matvec replays a CUDA graph of the same jvp and
vjp, captured once per solver call: the card runs the same kernels
without the host's cost of launching each of the many small ones.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jvp, vjp
from torch.utils import _pytree as pytree

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
    params: tuple              # the params' tree
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


def _graphed_normal_matvec(rflat: Callable, theta: torch.Tensor) -> Callable:
    """A CUDA graph of v ↦ Jᵀ(J v) + c·v, J the Jacobian of rflat at a
    point. Returns at(θ, c) -> matvec: at sets the point and the damping c,
    matvec(v) copies v in and replays the graph. Its result is the graph's
    output buffer, overwritten by the next replay."""
    th = theta.detach().clone()
    v = torch.zeros_like(th)
    c = torch.zeros((), dtype=th.dtype, device=th.device)

    def body():
        _, jv = jvp(rflat, (th,), (v,))
        _, vjp_fn = vjp(rflat, th)
        return vjp_fn(jv)[0] + c * v

    main = torch.cuda.current_stream(th.device)
    side = torch.cuda.Stream(device=th.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(2):                # lazy library set-up outside the capture
            body()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()

    def at(theta, lam_curv):
        th.copy_(theta)
        c.copy_(lam_curv)

        def matvec(p):
            v.copy_(p)
            graph.replay()
            return out
        return matvec

    return at


def make_lm_solver(residual_fn: Callable, params_template, steps: int = 100,
                   cg_iters: int = 50, lam0: float = 1e-2, lam_min: float = 1e-9,
                   lam_max: float = 1e6, graph: bool | None = None) -> Callable:
    """solver(params, batch, gamma, scale) -> LMResult: `steps` LM steps
    with Marquardt damping λ·curv (curv = ‖J ĝ‖², ĝ the unit gradient) and
    accept/reject trust-region updates of λ. graph (None: on a CUDA
    device) replays each CG matvec from a CUDA graph; False launches it op
    by op. The params are any tree of tensors (the MLP's (W, b) pairs,
    Helmholtz's dict with its 0-d k), flattened to one vector θ in
    torch.utils._pytree's leaf order, as the JAX package ravels its tree."""
    leaves, tree = pytree.tree_flatten(params_template)
    shapes = [t.shape for t in leaves]
    sizes = [int(np.prod(s)) for s in shapes]

    def unravel(theta):
        return pytree.tree_unflatten(
            [c.view(s) for c, s in zip(torch.split(theta, sizes), shapes)], tree)

    def solver(params, batch, gamma, scale) -> LMResult:
        pin_full_f32()
        theta = torch.cat([t.detach().reshape(-1) for t in pytree.tree_leaves(params)])
        lam = lam0

        def rflat(th):
            return residual_fn(unravel(th), batch, gamma, scale)

        graphed = (_graphed_normal_matvec(rflat, theta)
                   if (theta.is_cuda if graph is None else graph) else None)
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

            if graphed is not None:
                matvec = graphed(theta, lam * curv)
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
        return LMResult(pytree.tree_map(torch.Tensor.detach, unravel(theta)),
                        float(loss_hist[-1]), loss_hist, np.asarray(lams))

    return solver


def to_f64(tree):
    """Every floating tensor of a params tuple or batch dict as float64 on
    its device (integer tensors unchanged)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float64) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: to_f64(v) for k, v in tree.items()}
    return type(tree)(to_f64(v) for v in tree)


def lm_polish_x64(residual_fn: Callable, params, batch, gamma, scale,
                  steps: int = 20, cg_iters: int = 60) -> LMResult:
    """float64 Levenberg–Marquardt endgame, port of
    `gpe_tpu.train.gauss_newton.lm_polish_x64`.

    Starts from an (f32, polished) state and squeezes out the f32
    arithmetic floor: forward-Laplacian, residual and CG all run in float64
    on the device the batch lies on (the JAX package moves this to its host
    CPU). The plain autograd path only: the fused kernels are f32.
    Returns LMResult with float64 params."""
    p64 = to_f64(params)
    lm = make_lm_solver(residual_fn, p64, steps=steps, cg_iters=cg_iters)
    return lm(p64, to_f64(batch), float(gamma), float(scale))
