"""Rotating-frame GPE with complex ψ — vortex states (BASELINE config #5),
port of `gpe_tpu/rotating/problem.py`.

The wavefunction is complex: a two-output MLP gives (Re ψ, Im ψ), and one
forward-Laplacian pass (`fwdlap_mlp`, multi-output) gives the value, the
Jacobian (N, d, out) and the Laplacian of both channels. With ψ = a + ib,
ρ = a² + b², L_z = −i(x∂_y − y∂_x):

    Hψ|_re = −c·Δa + (V + γρ)·a − Ω·(x·b_y − y·b_x)
    Hψ|_im = −c·Δb + (V + γρ)·b + Ω·(x·a_y − y·a_x)

μ = ⟨ψ, Hψ⟩/⟨ψ, ψ⟩, the residual r = Hψ − μψ, and
⟨L_z⟩ = ∫ a(x b_y − y b_x) − b(x a_y − y a_x).

`train_rotating_vortex`: the float64 ADI oracle (`validate/rotating.py`, on
the device), distillation of (Re, Im) into the net (`pretrain_to_base`, or
`pretrain_sobolev` with the oracle's spectral gradients), a Levenberg–
Marquardt polish of the normalised complex residual (Ω in the solver's
`scale` slot), and the mesh-free report. Autograd throughout: the fused
kernels take scalar-output nets only, as in the JAX package. Entry points
run on the CUDA card unless `device="cpu"`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.models.mlp import init_mlp, mlp_apply, mlp_vgl
from gpe_tpu_torch.ops import quadrature
from gpe_tpu_torch.ops.collectives import psum


@dataclass(frozen=True)
class RotatingSpec:
    lb: float = -8.0
    ub: float = 8.0
    n_points: int = 96                      # grid side (n² collocation points)
    layers: tuple = (2, 100, 100, 100, 2)   # 2 outputs: (Re ψ, Im ψ)
    activation: str = "tanh"
    init_scheme: str = "xavier_uniform"     # "siren" pairs with activation="sin"
    w0: float = 4.0                         # siren first-layer frequency reach
    trap: float = 0.5                       # V = trap·r²  (ω_trap² / 2)
    kinetic: float = 0.5
    gamma: float = 50.0
    omega: float = 0.7                      # rotation rate (< trap frequency)
    bc_weight: float = 10.0
    norm_weight: float = 20.0


def make_rotating_batch(spec: RotatingSpec, device=None) -> dict:
    """The n² grid x, V = trap·r², the weights dx², and 4 × 64 boundary
    points on the box's edges; built in float64, stored in float32."""
    dev = resolve_device(device)
    f64 = torch.float64
    x = quadrature.uniform_grid(spec.lb, spec.ub, spec.n_points, d=2, dtype=f64,
                                device=dev)
    dx = (spec.ub - spec.lb) / (spec.n_points - 1)
    edges = torch.linspace(spec.lb, spec.ub, 64, dtype=f64, device=dev)
    lo, hi = torch.full_like(edges, spec.lb), torch.full_like(edges, spec.ub)
    bx = torch.cat([torch.stack([edges, lo], -1), torch.stack([edges, hi], -1),
                    torch.stack([lo, edges], -1), torch.stack([hi, edges], -1)])
    f32 = torch.float32
    return {"x": x.to(f32), "V": (spec.trap * torch.sum(x * x, dim=-1)).to(f32),
            "w": torch.full((x.shape[0],), dx * dx, dtype=f32, device=dev),
            "bx": bx.to(f32)}


def _complex_fields(net):
    """(a, b, a_x, a_y, b_x, b_y, lap_a, lap_b) of (value (N, 2), jac
    (N, d, 2), lap (N, 2))."""
    val, jac, lap = net
    return (val[:, 0], val[:, 1], jac[:, 0, 0], jac[:, 1, 0], jac[:, 0, 1],
            jac[:, 1, 1], lap[:, 0], lap[:, 1])


def _hamiltonian(fields, x, V, gamma, omega, kinetic):
    """(Hψ re, Hψ im, ρ) of the rotating frame."""
    a, b, a_x, a_y, b_x, b_y, lap_a, lap_b = fields
    X, Y = x[:, 0], x[:, 1]
    rho = a * a + b * b
    Veff = V + gamma * rho
    h_re = -kinetic * lap_a + Veff * a - omega * (X * b_y - Y * b_x)
    h_im = -kinetic * lap_b + Veff * b + omega * (X * a_y - Y * a_x)
    return h_re, h_im, rho


def make_rotating_loss_fn(spec: RotatingSpec):
    """loss_fn(params, batch, gamma, omega, group=None) -> (total, aux with
    pde, boundary, norm, mu, lz, total). γ and Ω are numbers or 0-d tensors.
    `group` (a process group; JAX's `axis_name`): the batch's grid points
    are this rank's shard, every point sum is summed over the ranks; the
    boundary points are replicated."""
    def loss_fn(params, batch, gamma, omega, group=None):
        x = batch["x"]
        f = _complex_fields(mlp_vgl(params, x, spec.activation))
        a, b, a_x, a_y, b_x, b_y = f[:6]
        h_re, h_im, rho = _hamiltonian(f, x, batch["V"], gamma, omega, spec.kinetic)

        def _red(v):
            return psum(torch.sum(v, dtype=torch.promote_types(v.dtype, torch.float32)),
                        group)

        n_pts = _red(torch.ones_like(a))
        mu = _red(a * h_re + b * h_im) / (_red(rho) + 1e-12)
        r_re, r_im = h_re - mu * a, h_im - mu * b
        pde = _red(r_re * r_re + r_im * r_im) / n_pts
        bv = mlp_apply(params, batch["bx"], spec.activation)
        boundary = torch.mean(bv * bv, dtype=torch.promote_types(bv.dtype, torch.float32))
        mass = _red(rho * batch["w"])
        norm = (mass - 1.0) ** 2
        X, Y = x[:, 0], x[:, 1]
        lz = _red((a * (X * b_y - Y * b_x) - b * (X * a_y - Y * a_x)) * batch["w"]) / (
            mass + 1e-12)
        total = pde + spec.bc_weight * boundary + spec.norm_weight * norm
        return total, {"pde": pde, "boundary": boundary, "norm": norm, "mu": mu,
                       "lz": lz, "total": total}

    return loss_fn


def make_rotating_residual_fn(spec: RotatingSpec):
    """residuals(params, batch, gamma, omega) -> the normalised complex
    residual ((Hψ − μψ)_re, (Hψ − μψ)_im) / √N of ψ scaled to Σ|ψ|²w = 1:
    the LM polish's vector (Ω rides in the solver's `scale` slot)."""
    def residuals(params, batch, gamma, omega):
        n = mlp_vgl(params, batch["x"], spec.activation)
        norm = torch.sqrt(torch.sum(torch.sum(n.value * n.value, dim=-1) * batch["w"])
                          + 1e-30)
        f = _complex_fields((n.value / norm, n.grad / norm, n.lap / norm))
        h_re, h_im, rho = _hamiltonian(f, batch["x"], batch["V"], gamma, omega,
                                       spec.kinetic)
        a, b = f[0], f[1]
        mu = torch.sum(a * h_re + b * h_im) / (torch.sum(rho) + 1e-12)
        N = math.sqrt(float(a.shape[0]))
        return torch.cat([(h_re - mu * a) / N, (h_im - mu * b) / N])

    return residuals


class RotatingResult(NamedTuple):
    params: tuple
    mu: float            # mesh-free μ (the net's analytic derivatives)
    mu_grid: float       # f64 ADI oracle μ
    lz: float            # mesh-free ⟨L_z⟩
    lz_grid: float
    n_vortices: int
    pde_loss: float
    fit_mse: float
    energy: float = 0.0  # mesh-free GP energy E[ψ_net] (γ/2 interaction): the
    # ordering statistic of near-degenerate vortex configurations
    polish: dict | None = None  # the LM polish's verdict: "accepted", and μ,
    # pde, ⟨L_z⟩ and E "before" and "after" it (None without a polish)


def _report(params, batch, spec, gamma, omega):
    """(μ, pde, ⟨L_z⟩, E) of the net normalised to Σ|ψ|²w = 1, mesh-free."""
    with torch.no_grad():
        n = mlp_vgl(params, batch["x"], spec.activation)
        w = batch["w"]
        norm = torch.sqrt(torch.sum(torch.sum(n.value * n.value, dim=-1) * w) + 1e-30)
        f = _complex_fields((n.value / norm, n.grad / norm, n.lap / norm))
        a, b, a_x, a_y, b_x, b_y = f[:6]
        x = batch["x"]
        h_re, h_im, rho = _hamiltonian(f, x, batch["V"], gamma, omega, spec.kinetic)
        mu = torch.sum(a * h_re + b * h_im) / (torch.sum(rho) + 1e-12)
        pde = torch.mean((h_re - mu * a) ** 2 + (h_im - mu * b) ** 2)
        X, Y = x[:, 0], x[:, 1]
        lz_dens = a * (X * b_y - Y * b_x) - b * (X * a_y - Y * a_x)
        lz = torch.sum(lz_dens * w)
        grad2 = a_x * a_x + a_y * a_y + b_x * b_x + b_y * b_y
        e = torch.sum(w * (spec.kinetic * grad2 + batch["V"] * rho
                           + 0.5 * gamma * rho * rho - omega * lz_dens))
    return float(mu), float(pde), float(lz), float(e)


def train_rotating_vortex(spec: RotatingSpec, fit_epochs: int = 4000,
                          lbfgs_steps: int = 300, polish_steps: int = 60,
                          polish_cg_iters: int = 60, oracle_tau: float = 2e-3,
                          oracle_steps: int = 40000, seed: int = 0, target=None,
                          sobolev: bool = False, jac_weight: float = 0.1,
                          sobolev_n: int = 0, verbose: bool = False,
                          device=None) -> RotatingResult:
    """Solve the rotating-frame GPE: the f64 ADI oracle → distil (Re, Im)
    into the complex net → LM polish of the normalised complex residual →
    the mesh-free μ and ⟨L_z⟩. The polished net is kept only if its pde
    falls and its ⟨L_z⟩ moves by less than 0.2 (LM pulls to the nearest
    residual minimum, which from a loosely fit multi-vortex state can be a
    lower-circulation branch).

    target: an optional (ψ (n, n) complex, μ_grid, L_z_grid) in place of the
    oracle run: a specific (grid-refined) vortex configuration. sobolev:
    H¹ distillation (values and the oracle's spectral gradients), on its
    own `sobolev_n`² grid when that differs from the spec's (the oracle
    field regridded by cubic splines). The initial params come from
    `init_mlp` with a CPU generator seeded by `seed`."""
    from gpe_tpu_torch.train.gauss_newton import make_lm_solver
    from gpe_tpu_torch.train.pretrain import pretrain_sobolev, pretrain_to_base
    from gpe_tpu_torch.validate.rotating import (_spectral_grads, regrid_psi,
                                                 rotating_imaginary_time, vortex_count)

    pin_full_f32()
    dev = resolve_device(device)
    batch = make_rotating_batch(spec, dev)
    n_side = spec.n_points
    x1 = np.linspace(spec.lb, spec.ub, n_side)
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    if target is not None:
        psi, mu_grid, lz_grid = target
        psi = torch.as_tensor(psi, dtype=torch.complex128, device=dev)
        if tuple(psi.shape) != (n_side, n_side):
            raise ValueError(f"target ψ is {tuple(psi.shape)}, the grid {n_side}²")
    else:
        mu_grid, psi, lz_grid = rotating_imaginary_time(
            spec.trap * (X ** 2 + Y ** 2), x1, spec.gamma, spec.omega,
            kinetic=spec.kinetic, tau=oracle_tau, steps=oracle_steps, device=dev)
    nv = vortex_count(psi)
    if verbose:
        print(f"oracle: μ={mu_grid:.6f} Lz={lz_grid:.4f} vortices={nv}", flush=True)

    params = init_mlp(spec.layers, scheme=spec.init_scheme, w0=spec.w0,
                      generator=torch.Generator().manual_seed(seed), device=dev)
    f32 = lambda a: a.to(device=dev, dtype=torch.float32)
    if sobolev:
        if sobolev_n and sobolev_n != n_side:
            xs = np.linspace(spec.lb, spec.ub, sobolev_n)
            psi_s, ns = regrid_psi(psi, x1, xs), sobolev_n
        else:
            xs, psi_s, ns = x1, psi, n_side
        Xs, Ys = np.meshgrid(xs, xs, indexing="ij")
        x_s = f32(torch.as_tensor(np.stack([Xs.ravel(), Ys.ravel()], -1)))
        tval = f32(torch.stack([psi_s.real.reshape(-1), psi_s.imag.reshape(-1)], -1))
        gx, gy = _spectral_grads(psi_s, float(xs[1] - xs[0]))
        tjac = f32(torch.stack([torch.stack([gx.real.reshape(-1), gx.imag.reshape(-1)], -1),
                                torch.stack([gy.real.reshape(-1), gy.imag.reshape(-1)], -1)],
                               dim=1))                              # (N, d, out)
        params, fit_mse = pretrain_sobolev(params, x_s, tval, tjac, spec.activation,
                                           epochs=fit_epochs, lbfgs_steps=lbfgs_steps,
                                           jac_weight=jac_weight)
    else:
        tval = f32(torch.stack([psi.real.reshape(-1), psi.imag.reshape(-1)], -1))
        params, fit_mse = pretrain_to_base(params, batch["x"], tval, spec.activation,
                                           epochs=fit_epochs, lbfgs_steps=lbfgs_steps)
    if verbose:
        print(f"distill fit MSE {fit_mse:.3e}", flush=True)

    gamma, omega = float(np.float32(spec.gamma)), float(np.float32(spec.omega))
    mu, pde, lz, energy = _report(params, batch, spec, gamma, omega)
    polish = None
    if polish_steps > 0:
        lm = make_lm_solver(make_rotating_residual_fn(spec), params, steps=polish_steps,
                            cg_iters=polish_cg_iters)
        polished = lm(params, batch, gamma, omega).params
        mu_p, pde_p, lz_p, e_p = _report(polished, batch, spec, gamma, omega)
        keys = ("mu", "pde", "lz", "energy")
        polish = {"accepted": bool(pde_p < pde and abs(lz_p - lz) < 0.2),
                  "before": dict(zip(keys, (mu, pde, lz, energy))),
                  "after": dict(zip(keys, (mu_p, pde_p, lz_p, e_p)))}
        if polish["accepted"]:
            params, mu, pde, lz, energy = polished, mu_p, pde_p, lz_p, e_p
    return RotatingResult(params, mu, float(mu_grid), lz, float(lz_grid), nv, pde,
                          float(fit_mse), energy, polish)
