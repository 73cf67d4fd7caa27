"""Sobolev-preconditioned natural-gradient flow for GPE ground states, port
of `gpe_tpu/train/sobolev_ngd.py` (after the projected-Sobolev-NGD idea,
arXiv:2512.11339): descend in function space and project back.

1. u_θ and its analytic Laplacian (forward-Laplacian pass), normalised.
2. The function-space gradient of the Rayleigh functional at fixed norm:
   r = H[u]u − μu.
3. H¹ preconditioning on the uniform collocation grid:
   d = F⁻¹[ F[r] / (1 + α|k|²) ], one FFT pair.
4. Flow step: target = normalize(u − η·d), back at the net's own scale.
5. Projection: `inner_steps` Adam steps on ‖u_θ − target‖², one Adam
   state across the outer steps; on a CUDA device the steps replay a CUDA
   graph of one step (`pretrain.AdamSteps`), the target refilled in a
   static buffer each outer step.

Dims 1 and 2, as in JAX (it builds no 3D preconditioner): a 3D spec raises
ValueError.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.ops.rayleigh import hamiltonian_apply
from gpe_tpu_torch.train.pretrain import AdamSteps
from gpe_tpu_torch.train.problem import GPESpec


class SNGDResult(NamedTuple):
    params: any
    mu: float
    pde_loss: float
    mu_history: np.ndarray
    loss_history: np.ndarray


def make_sngd_solver(spec: GPESpec, outer_steps: int = 300, inner_steps: int = 60,
                     eta: float = 0.4, alpha: float = 1.0, inner_lr: float = 2e-3):
    """solver(params, batch, gamma) -> SNGDResult for a vanilla ansatz (u =
    net; spec.use_perturbation is ignored). The batch must be a full uniform
    grid (make_batch(spec, mode)); the solver runs on its device."""
    if spec.dim not in (1, 2):
        raise ValueError(f"make_sngd_solver handles dims 1 and 2 (the JAX "
                         f"package's preconditioner), not {spec.dim}")
    n_side = spec.n_points
    dim = spec.dim
    act = spec.activation
    dx = (spec.ub - spec.lb) / (n_side - 1)
    axes = tuple(range(dim))

    def solver(params, batch, gamma) -> SNGDResult:
        pin_full_f32()
        x, w, V = batch["x"], batch["w"], batch["V"]
        k1 = 2.0 * math.pi * torch.fft.fftfreq(n_side, d=dx, dtype=x.dtype,
                                                device=x.device)
        k2 = k1 ** 2 if dim == 1 else k1[:, None] ** 2 + k1[None, :] ** 2
        sob = 1.0 / (1.0 + alpha * k2)
        g32 = torch.tensor(float(np.float32(gamma)), dtype=x.dtype, device=x.device)
        leaves = [t.detach().clone().requires_grad_(True) for pair in params for t in pair]
        pairs = tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))
        target = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        adam = AdamSteps(lambda: torch.mean((mlp.mlp_apply(pairs, x, act) - target) ** 2),
                         leaves, inner_lr, graph=x.is_cuda)
        mus, pdes = [], []
        for _ in range(outer_steps):
            with torch.no_grad():
                n = mlp.mlp_vgl(pairs, x, act)
                norm = torch.sqrt(torch.sum(n.value ** 2 * w) + 1e-30)
                u = n.value / norm
                lap = n.lap / norm
                hu = hamiltonian_apply(u, lap, V, g32, spec.p, spec.kinetic,
                                       spec.nonlinearity)
                mu = torch.sum(u * hu * w)
                r = hu - mu * u
                pdes.append(torch.mean(r * r))
                mus.append(mu)
                grid = r.reshape((n_side,) * dim)
                d = torch.fft.ifftn(torch.fft.fftn(grid, dim=axes) * sob,
                                    dim=axes).real.reshape(-1)
                t = u - eta * d
                t = t / torch.sqrt(torch.sum(t ** 2 * w) + 1e-30)
                target.copy_(t * norm)      # back to the net's own scale
            adam.run(inner_steps)
        out = tuple((a.detach(), b.detach()) for a, b in pairs)
        mus = torch.stack(mus).cpu().numpy()
        pdes = torch.stack(pdes).cpu().numpy()
        return SNGDResult(out, float(mus[-1]), float(pdes[-1]), mus, pdes)

    return solver
