"""Problem assembly: spec → batch → loss fn, port of `gpe_tpu/train/problem.py`.

Everything analytic and shape-static (grid, weights, potential, base triple,
boundary probes) is computed once into a `batch` dict of device tensors; γ
and the perturbation scale are call arguments, so one loss function serves a
whole continuation ramp.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import torch

from gpe_tpu_torch.device import resolve_device
from gpe_tpu_torch.losses.balancing import fixed_weights_total
from gpe_tpu_torch.losses.gpe import GPETerms, gpe_terms
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.models.ansatz import plain_ansatz
from gpe_tpu_torch.ops import quadrature
from gpe_tpu_torch.physics import bases, potentials


@dataclass(frozen=True)
class GPESpec:
    """Static description of a GPE PINN problem (defaults: the reference
    paper's 1D configuration)."""
    lb: float = -10.0
    ub: float = 10.0
    n_points: int = 4000
    dim: int = 1
    layers: tuple = (1, 64, 64, 64, 1)
    activation: str = "shifted_tanh"
    potential: str = "harmonic"
    potential_kwargs: tuple = ()
    basis: str = "hermite"
    p: float = 3.0
    kinetic: float = 1.0
    nonlinearity: str = "power"
    objective: str = "pde"
    pde_weight: float = 1.0
    bc_weight: float = 10.0
    norm_weight: float = 20.0
    sym_weight: float = 0.0
    riesz_weight: float = 0.0
    symmetry: str | None = None
    norm_style: str = "riemann"
    anti_trivial: bool = False
    anti_trivial_c: float = 2.0
    anti_trivial_weight: float = 1.0
    width_weight: float = 0.0
    weighting: str = "fixed"
    use_perturbation: bool = True
    hard_bc: bool = False
    geometry: str = "square"
    center: tuple = ()
    radius: float = 0.0
    n_boundary: int = 256
    mu_report_shift: float = 0.0
    dtype: torch.dtype = torch.float32

    def terms_cfg(self) -> GPETerms:
        use_riesz = self.objective == "riesz" or self.riesz_weight > 0.0
        return GPETerms(p=self.p, kinetic=self.kinetic,
                        nonlinearity=self.nonlinearity,
                        norm_style=self.norm_style,
                        symmetry=self.symmetry if self.sym_weight > 0.0 else None,
                        use_riesz=use_riesz, anti_trivial=self.anti_trivial,
                        anti_trivial_c=self.anti_trivial_c,
                        width_penalty=self.width_weight > 0.0,
                        mu_report_shift=self.mu_report_shift)

    def loss_weights(self) -> dict:
        w = {"pde": self.pde_weight, "boundary": self.bc_weight,
             "norm": self.norm_weight}
        if self.objective == "riesz":
            w["riesz"] = 1.0
        elif self.riesz_weight > 0.0:
            w["riesz"] = self.riesz_weight
        if self.symmetry is not None and self.sym_weight > 0.0:
            w["sym"] = self.sym_weight
        if self.anti_trivial:
            for k in ("reg_f", "reg_lambda", "reg_drive"):
                w[k] = self.anti_trivial_weight
        if self.width_weight > 0.0:
            w["width"] = self.width_weight
        return w


def base_triple(spec: GPESpec, mode: int, x: torch.Tensor) -> bases.ValGradLap:
    """Analytic base eigenfunction triple (Hermite family; 2D and d≥3 use
    tensor products with the mode on the first axis)."""
    if spec.basis in ("hermite", "hermite2d"):
        if spec.dim == 2 or spec.basis == "hermite2d":
            return bases.hermite_product_2d(mode, 0, x)
        if spec.dim >= 3:
            return bases.hermite_product_nd((mode,) + (0,) * (spec.dim - 1), x)
        return bases.hermite_basis(mode, x)
    raise NotImplementedError(
        f"basis {spec.basis!r} is not ported yet; see "
        "gpe_tpu.train.problem.base_triple")


def make_batch(spec: GPESpec, mode: int, device=None) -> dict:
    """Grid, Riemann weights, potential, base triple and boundary probes on
    `device` (square geometry). Built in float64, stored in spec.dtype."""
    dev = resolve_device(device)
    if spec.geometry != "square":
        raise NotImplementedError(
            f"geometry {spec.geometry!r} is not ported yet; see "
            "gpe_tpu.train.problem.make_batch")
    if spec.symmetry is not None:
        raise NotImplementedError(
            "symmetry reflections are not ported yet; see "
            "gpe_tpu.train.problem.make_batch")
    f64 = torch.float64
    x = quadrature.uniform_grid(spec.lb, spec.ub, spec.n_points, d=spec.dim,
                                dtype=f64, device=dev)
    dx = (spec.ub - spec.lb) / (spec.n_points - 1)
    w = torch.full((x.shape[0],), dx ** spec.dim, dtype=f64, device=dev)
    vfn = potentials.get_potential(spec.potential, **dict(spec.potential_kwargs))
    V = vfn(x)
    if spec.dim == 1:
        bx = torch.tensor([[spec.lb], [spec.ub]], dtype=f64, device=dev)
    elif spec.dim == 2:
        edges = torch.linspace(spec.lb, spec.ub, 64, dtype=f64, device=dev)
        lo = torch.full_like(edges, spec.lb)
        hi = torch.full_like(edges, spec.ub)
        bx = torch.cat([torch.stack([edges, lo], -1), torch.stack([edges, hi], -1),
                        torch.stack([lo, edges], -1), torch.stack([hi, edges], -1)],
                       dim=0)
    else:
        m = max(2, int(round((256.0 / (2 * spec.dim)) ** (1.0 / (spec.dim - 1)))))
        face_pts = quadrature.uniform_grid(spec.lb, spec.ub, m, d=spec.dim - 1,
                                           dtype=f64, device=dev)
        faces = []
        for axis in range(spec.dim):
            for bound in (spec.lb, spec.ub):
                col = torch.full((face_pts.shape[0], 1), bound, dtype=f64,
                                 device=dev)
                faces.append(torch.cat([face_pts[:, :axis], col,
                                        face_pts[:, axis:]], dim=1))
        bx = torch.cat(faces, dim=0)
    batch = {"x": x, "w": w, "V": V, "bx": bx}
    if spec.use_perturbation:
        b = base_triple(spec, mode, x)
        batch["base_val"] = b.value
        batch["base_grad"] = b.grad
        batch["base_lap"] = b.lap
        batch["base_bval"] = base_triple(spec, mode, bx).value
    return {k: v.to(spec.dtype).contiguous() for k, v in batch.items()}


def spec_ansatz(spec: GPESpec):
    if spec.hard_bc:
        raise NotImplementedError(
            "the hard-BC ansatz is not ported yet; see "
            "gpe_tpu.models.ansatz.hard_bc_ansatz")
    act = spec.activation
    return plain_ansatz(lambda p, x: mlp.mlp_vgl(p, x, act),
                        lambda p, x: mlp.mlp_apply(p, x, act))


def make_terms_fn(spec: GPESpec) -> Callable:
    """terms_fn(net_params, batch, gamma, scale) -> TermsOutput from ONE
    forward-Laplacian evaluation of the complete solution."""
    cfg = spec.terms_cfg()
    a = spec_ansatz(spec)

    def terms_fn(net_params, batch, gamma, scale):
        n = a.vgl(net_params, batch["x"], 1.0)
        u = scale * n.value
        grad = scale * n.grad
        lap = scale * n.lap
        bv = a.value(net_params, batch["bx"], 1.0) * scale
        if spec.use_perturbation:
            u = batch["base_val"] + u
            grad = batch["base_grad"] + grad
            lap = batch["base_lap"] + lap
            bv = batch["base_bval"] + bv
        return gpe_terms(u, grad, lap, bv, batch["V"], batch["w"], gamma, cfg)

    return terms_fn


def init_params(spec: GPESpec, generator: torch.Generator | None = None,
                scheme: str = "xavier_uniform", mode: int = 0, device=None):
    """Trainable params for a spec (fixed weighting: the raw MLP params)."""
    if spec.weighting != "fixed":
        raise NotImplementedError(
            f"weighting {spec.weighting!r} is not ported yet; see "
            "gpe_tpu.train.problem.init_params")
    return mlp.init_mlp(spec.layers, scheme, mode=mode, generator=generator,
                        dtype=spec.dtype, device=resolve_device(device))


def make_loss_fn(spec: GPESpec) -> Callable:
    """loss_fn(params, batch, gamma, scale) -> (total, aux) with fixed
    weighting Σ wᵢ·Lᵢ (paper: pde + 10·bc + 20·norm)."""
    if spec.weighting != "fixed":
        raise NotImplementedError(
            f"weighting {spec.weighting!r} is not ported yet; see "
            "gpe_tpu.train.problem.make_loss_fn")
    terms_fn = make_terms_fn(spec)
    weights = spec.loss_weights()

    def loss_fn(params, batch, gamma, scale):
        out = terms_fn(params, batch, gamma, scale)
        total = fixed_weights_total(out.losses, weights)
        aux = dict(out.losses)
        aux["mu"] = out.mu
        aux["total"] = total
        return total, aux

    return loss_fn


def _resolve_relaxed(relaxed, fresh_values, extrapolate):
    """The relaxed-mode triple. No explicit choice and no env → relaxed +
    fresh_values + extrapolate (the JAX package's default);
    GPE_TPU_TORCH_NO_RELAXED=1 → the exact two-kernel step. Explicit
    kwargs always win."""
    if relaxed is None:
        relaxed = not os.environ.get("GPE_TPU_TORCH_NO_RELAXED")
        if relaxed and fresh_values is None and extrapolate is None:
            fresh_values = extrapolate = True
    return bool(relaxed), bool(fresh_values), bool(extrapolate)


def make_fused_value_and_grad(spec: GPESpec, device=None,
                              relaxed: bool | None = None,
                              refresh_every: int = 0,
                              extrapolate: bool | None = None,
                              exact_until: int = 0,
                              fresh_values: bool | None = None):
    """The fused CUDA training gradient (kernels/fused_grad.py) for eligible
    specs on a CUDA device, else None — fit() then uses autograd.

    Eligible = the loss the kernels model: plain or perturbation ansatz on a
    square grid, pde + boundary + norm with fixed weights, Riemann
    normalisation, f32, an activation with a σ‴ rule, a net the kernels take
    (`kernels.fused_grad.kernel_supports`), and a CUDA device. The JAX
    package's n ≥ 16384 gate was a TPU crossover and is not carried over.
    GPE_TPU_TORCH_NO_FUSED=1 disables the fused path."""
    from gpe_tpu_torch.kernels._common import kernel_supports
    from gpe_tpu_torch.kernels.fused_grad import make_value_and_grad

    if os.environ.get("GPE_TPU_TORCH_NO_FUSED"):
        return None
    relaxed, fresh_values, extrapolate = _resolve_relaxed(
        relaxed, fresh_values, extrapolate)
    ok = (resolve_device(device).type == "cuda"
          and spec.geometry == "square" and not spec.hard_bc
          and spec.objective == "pde" and spec.weighting == "fixed"
          and spec.riesz_weight == 0.0 and spec.sym_weight == 0.0
          and not spec.anti_trivial and spec.width_weight == 0.0
          and spec.mu_report_shift == 0.0
          and spec.pde_weight == 1.0 and spec.norm_style == "riemann"
          and spec.dtype == torch.float32
          and kernel_supports(spec.layers, spec.activation))
    if not ok:
        return None
    return make_value_and_grad(
        spec.layers, spec.activation, spec.p, spec.kinetic, spec.nonlinearity,
        bc_weight=spec.bc_weight, norm_weight=spec.norm_weight,
        delayed=relaxed, refresh_every=refresh_every, extrapolate=extrapolate,
        exact_until=exact_until, fresh_values=fresh_values)
