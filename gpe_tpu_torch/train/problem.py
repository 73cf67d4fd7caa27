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
from gpe_tpu_torch.losses.balancing import (fixed_weights_total, init_log_alpha,
                                            self_adaptive_total)
from gpe_tpu_torch.losses.gpe import GPETerms, gpe_terms
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.models.ansatz import box_sine_factor, hard_bc_ansatz, plain_ansatz
from gpe_tpu_torch.ops import geometry, quadrature
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
    """Base eigenfunction triple of the spec's basis family (in 2D and
    d ≥ 3 tensor products with the mode on the first axis); a
    "numeric:<name>" basis is looked up in physics.numeric.NUMERIC_BASES."""
    if spec.basis in ("hermite", "hermite2d"):
        if spec.dim == 2 or spec.basis == "hermite2d":
            return bases.hermite_product_2d(mode, 0, x)
        if spec.dim >= 3:
            return bases.hermite_product_nd((mode,) + (0,) * (spec.dim - 1), x)
        return bases.hermite_basis(mode, x)
    if spec.basis == "box":
        if spec.dim == 2:
            return bases.box_basis_2d(mode, 0, x, L=spec.ub - spec.lb)
        return bases.box_basis(mode, x, L=spec.ub - spec.lb)
    if spec.basis == "airy":
        return bases.airy_basis(mode, x)
    if spec.basis.startswith("numeric:"):
        # oracle-seeded sine-series base (physics/numeric.py): evaluated in
        # float64 at x, returned in x's dtype
        from gpe_tpu_torch.physics import numeric
        if spec.basis not in numeric.NUMERIC_BASES:
            raise KeyError(f"{spec.basis!r} not registered — call "
                           "physics.numeric.register_numeric_basis first")
        t = numeric.NUMERIC_BASES[spec.basis](mode, x)
        return bases.ValGradLap(*(a.to(x.dtype) for a in t))
    raise ValueError(f"unknown basis {spec.basis!r}")


def _boundary_points(spec: GPESpec, dev) -> torch.Tensor:
    """Dirichlet probes of the square [lb, ub]^d: both ends in 1D, 64 points
    an edge in 2D, a (d−1)-dim grid on each face for d ≥ 3."""
    f64 = torch.float64
    if spec.dim == 1:
        return torch.tensor([[spec.lb], [spec.ub]], dtype=f64, device=dev)
    if spec.dim == 2:
        edges = torch.linspace(spec.lb, spec.ub, 64, dtype=f64, device=dev)
        lo = torch.full_like(edges, spec.lb)
        hi = torch.full_like(edges, spec.ub)
        return torch.cat([torch.stack([edges, lo], -1), torch.stack([edges, hi], -1),
                          torch.stack([lo, edges], -1), torch.stack([hi, edges], -1)],
                         dim=0)
    m = max(2, int(round((256.0 / (2 * spec.dim)) ** (1.0 / (spec.dim - 1)))))
    face_pts = quadrature.uniform_grid(spec.lb, spec.ub, m, d=spec.dim - 1,
                                       dtype=f64, device=dev)
    faces = []
    for axis in range(spec.dim):
        for bound in (spec.lb, spec.ub):
            col = torch.full((face_pts.shape[0], 1), bound, dtype=f64, device=dev)
            faces.append(torch.cat([face_pts[:, :axis], col, face_pts[:, axis:]],
                                   dim=1))
    return torch.cat(faces, dim=0)


def make_batch(spec: GPESpec, mode: int, device=None) -> dict:
    """Grid, weights, potential, base triple, boundary probes and (with a
    symmetry) the reflected points on `device`. geometry="square": the
    uniform grid on [lb, ub]^d with Riemann weights; "disk" (2D): n_points²
    sunflower points, equal-area weights and n_boundary rim probes. Built in
    float64, stored in spec.dtype."""
    dev = resolve_device(device)
    f64 = torch.float64
    if spec.geometry == "disk":
        if spec.dim != 2:
            raise ValueError("disk geometry requires dim=2")
        center = spec.center or ((spec.lb + spec.ub) / 2.0,) * 2
        radius = spec.radius or (spec.ub - spec.lb) / 2.0
        n_total = spec.n_points ** 2
        x = geometry.disk_points(center, radius, n_total, f64, dev)
        w = geometry.disk_weights(radius, n_total, f64, dev)
        bx = geometry.circle_points(center, radius, spec.n_boundary, f64, dev)
    elif spec.geometry == "square":
        x = quadrature.uniform_grid(spec.lb, spec.ub, spec.n_points, d=spec.dim,
                                    dtype=f64, device=dev)
        dx = (spec.ub - spec.lb) / (spec.n_points - 1)
        w = torch.full((x.shape[0],), dx ** spec.dim, dtype=f64, device=dev)
        bx = _boundary_points(spec, dev)
    else:
        raise ValueError(f"unknown geometry {spec.geometry!r}")
    vfn = potentials.get_potential(spec.potential, **dict(spec.potential_kwargs))
    batch = {"x": x, "w": w, "V": vfn(x), "bx": bx}
    if spec.use_perturbation:
        b = base_triple(spec, mode, x)
        batch["base_val"] = b.value
        batch["base_grad"] = b.grad
        batch["base_lap"] = b.lap
        batch["base_bval"] = base_triple(spec, mode, bx).value
    if spec.symmetry is not None and spec.geometry == "square":
        if spec.symmetry == "interval":
            xr = (spec.lb + spec.ub) - x
        elif spec.symmetry == "y_even":
            # u(x, y) = u(x, −y): the last coordinate flips
            flip = torch.tensor([1.0] * (spec.dim - 1) + [-1.0], dtype=f64, device=dev)
            xr = x * flip
        else:
            xr = -x
        batch["x_reflect"] = xr
        if spec.use_perturbation:
            batch["base_val_reflect"] = base_triple(spec, mode, xr).value
    return {k: v.to(spec.dtype).contiguous() for k, v in batch.items()}


def spec_ansatz(spec: GPESpec):
    """The ansatz of the loss: ψ = g·s·N with the box's sine factor g for a
    hard-BC spec, else ψ = s·N (the perturbation base enters through the
    batch arrays)."""
    act = spec.activation
    net_vgl = lambda p, x: mlp.mlp_vgl(p, x, act)
    net_value = lambda p, x: mlp.mlp_apply(p, x, act)
    if spec.hard_bc:
        return hard_bc_ansatz(net_vgl, net_value, box_sine_factor(spec.lb, spec.ub))
    return plain_ansatz(net_vgl, net_value)


def make_terms_fn(spec: GPESpec) -> Callable:
    """terms_fn(net_params, batch, gamma, scale, group=None) -> TermsOutput
    from ONE forward-Laplacian evaluation of the complete solution
    (perturbation and hard-BC composition here, the terms in losses/gpe.py);
    under a process group the batch's collocation arrays are this rank's
    shard and the sums run over every rank."""
    cfg = spec.terms_cfg()
    a = spec_ansatz(spec)

    def terms_fn(net_params, batch, gamma, scale, group=None):
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
        u_reflect = None
        if cfg.symmetry is not None:
            u_reflect = a.value(net_params, batch["x_reflect"], 1.0) * scale
            if spec.use_perturbation:
                u_reflect = batch["base_val_reflect"] + u_reflect
        x2 = torch.sum(batch["x"] * batch["x"], dim=-1) if cfg.width_penalty else None
        return gpe_terms(u, grad, lap, bv, batch["V"], batch["w"], gamma, cfg,
                         group=group, u_reflect=u_reflect, x2=x2)

    return terms_fn


def net_params(params):
    """The MLP params of a (possibly weighting-augmented) params tree."""
    if isinstance(params, dict) and "net" in params:
        return params["net"]
    return params


def init_params(spec: GPESpec, generator: torch.Generator | None = None,
                scheme: str = "xavier_uniform", mode: int = 0, device=None):
    """Trainable params of a spec on `device` (None → the CUDA card): the
    MLP params for fixed weighting, {"net", "log_alpha"} for self-adaptive
    (the log-weights train jointly with the net)."""
    dev = resolve_device(device)
    net = mlp.init_mlp(spec.layers, scheme, mode=mode, generator=generator,
                       dtype=spec.dtype, device=dev)
    if spec.weighting == "self_adaptive":
        return {"net": net, "log_alpha": init_log_alpha(spec.loss_weights(),
                                                        spec.dtype, dev)}
    return net


def make_loss_fn(spec: GPESpec) -> Callable:
    """loss_fn(params, batch, gamma, scale, group=None) -> (total, aux).
    weighting "fixed": Σ wᵢ·Lᵢ (paper: pde + 10·bc + 20·norm);
    "self_adaptive": params = {"net", "log_alpha"}, weights
    wᵢ·exp(log_alphaᵢ) that ascend (losses/balancing.py:
    self_adaptive_total). group: the process group of sharded collocation
    points (`make_terms_fn`; parallel/mesh.py:make_parallel_loss)."""
    terms_fn = make_terms_fn(spec)
    weights = spec.loss_weights()
    if spec.weighting == "self_adaptive":
        def total_of(params, losses):
            return self_adaptive_total(losses, params["log_alpha"], weights)
        net_of = net_params
    elif spec.weighting == "fixed":
        def total_of(params, losses):
            return fixed_weights_total(losses, weights)
        net_of = lambda params: params
    else:
        raise ValueError(f"unknown weighting {spec.weighting!r}")

    def loss_fn(params, batch, gamma, scale, group=None):
        out = terms_fn(net_of(params), batch, gamma, scale, group)
        total = total_of(params, out.losses)
        aux = dict(out.losses)
        aux["mu"] = out.mu
        aux["total"] = total
        return total, aux

    return loss_fn


def _env(name: str) -> str | None:
    """The port's switch GPE_TPU_TORCH_<name> (the JAX package reads
    GPE_TPU_<name>)."""
    return os.environ.get("GPE_TPU_TORCH_" + name)


def _resolve_relaxed(relaxed, fresh_values, extrapolate):
    """The relaxed-mode triple, resolved as the JAX package resolves it.
    No explicit choice and no env → relaxed + fresh_values + extrapolate
    (the JAX package's default); GPE_TPU_TORCH_NO_RELAXED=1 → the exact
    two-kernel step; GPE_TPU_TORCH_RELAXED_FUSED=1 → PLAIN relaxed, whose
    correctors come only from GPE_TPU_TORCH_RELAXED_EXTRAP=1 and
    GPE_TPU_TORCH_RELAXED_FRESH=1, which also fill any corrector left None.
    Explicit kwargs always win."""
    if relaxed is None:
        forced_plain = bool(_env("RELAXED_FUSED"))
        relaxed = forced_plain or not _env("NO_RELAXED")
        if (relaxed and not forced_plain
                and fresh_values is None and extrapolate is None):
            fresh_values = extrapolate = True
    if extrapolate is None:
        extrapolate = bool(_env("RELAXED_EXTRAP"))
    if fresh_values is None:
        fresh_values = bool(_env("RELAXED_FRESH"))
    return bool(relaxed), bool(fresh_values), bool(extrapolate)


def _env_int(value: int | None, name: str) -> int:
    """value, or GPE_TPU_TORCH_<name> (default 0) when it is None."""
    return int(_env(name) or 0) if value is None else int(value)


def _fused_loss(spec: GPESpec) -> bool:
    """The loss the fused kernels model: plain or perturbation ansatz on a
    square grid, pde + boundary + norm with fixed weights, Riemann
    normalisation, f32, and a net the CUDA kernels take
    (`kernels._common.kernel_supports`)."""
    from gpe_tpu_torch.kernels._common import kernel_supports
    return (spec.geometry == "square" and not spec.hard_bc
            and spec.objective == "pde" and spec.weighting == "fixed"
            and spec.riesz_weight == 0.0 and spec.sym_weight == 0.0
            and not spec.anti_trivial and spec.width_weight == 0.0
            and spec.mu_report_shift == 0.0
            and spec.pde_weight == 1.0 and spec.norm_style == "riemann"
            and spec.dtype == torch.float32
            and kernel_supports(spec.layers, spec.activation))


def make_fused_value_and_grad(spec: GPESpec, device=None,
                              relaxed: bool | None = None,
                              n_shards: int = 1,
                              refresh_every: int | None = None,
                              extrapolate: bool | None = None,
                              exact_until: int | None = None,
                              fresh_values: bool | None = None):
    """The fused CUDA training gradient (kernels/fused_grad.py) for eligible
    specs (`_fused_loss`) on a CUDA device, else None — fit() then uses
    autograd. The JAX package's n ≥ 16384 gate was a TPU crossover and is
    not carried over. GPE_TPU_TORCH_NO_FUSED=1 disables the fused path.
    The relaxed mode resolves as `_resolve_relaxed`; refresh_every and
    exact_until left None read GPE_TPU_TORCH_RELAXED_REFRESH and
    GPE_TPU_TORCH_RELAXED_EXACT_UNTIL (default 0).

    n_shards: the ranks of the mesh `fit(mesh=)` shards the points over;
    None when the collocation count does not divide over them, as in the
    JAX package. The vag is psum-aware either way (`vag.psum_aware`)."""
    from gpe_tpu_torch.kernels import fused_grad

    if _env("NO_FUSED") or (spec.n_points ** spec.dim) % n_shards:
        return None
    relaxed, fresh_values, extrapolate = _resolve_relaxed(
        relaxed, fresh_values, extrapolate)
    refresh_every = _env_int(refresh_every, "RELAXED_REFRESH")
    exact_until = _env_int(exact_until, "RELAXED_EXACT_UNTIL")
    if resolve_device(device).type != "cuda" or not _fused_loss(spec):
        return None
    return fused_grad.make_value_and_grad(
        spec.layers, spec.activation, spec.p, spec.kinetic, spec.nonlinearity,
        bc_weight=spec.bc_weight, norm_weight=spec.norm_weight,
        delayed=relaxed, refresh_every=refresh_every, extrapolate=extrapolate,
        exact_until=exact_until, fresh_values=fresh_values)


def packed_eligible(spec: GPESpec, n_runs: int) -> bool:
    """The JAX package's packed eligibility (`make_packed_value_and_grad`)
    without its TPU tile gates: at least 2 runs that the lane budget packs
    (`kernels.packing.packable_runs`) and the loss the fused kernels model."""
    from gpe_tpu_torch.kernels.packing import packable_runs
    return n_runs >= 2 and packable_runs(spec.layers) >= n_runs and _fused_loss(spec)


def packed_value_and_grad(spec: GPESpec, relaxed: bool | None = None,
                          refresh_every: int | None = None,
                          extrapolate: bool | None = None):
    """The run-mode fused gradient of a spec (kernels/fused_grad.py,
    runs=True) on whatever device its tensors lie: the kernels on the card,
    their plain versions on the CPU. The exact two-kernel step is the
    default; relaxed=None reads GPE_TPU_TORCH_RELAXED_FUSED=1 (opt-in, as in
    the JAX package, whose packed A/B found the relaxed mode less accurate).
    As in the JAX package's packed factory, refresh_every and extrapolate
    left None read GPE_TPU_TORCH_RELAXED_REFRESH / _EXTRAP, and exact_until
    and fresh_values always come from GPE_TPU_TORCH_RELAXED_EXACT_UNTIL /
    _FRESH."""
    from gpe_tpu_torch.kernels import fused_grad

    if relaxed is None:
        relaxed = bool(_env("RELAXED_FUSED"))
    if extrapolate is None:
        extrapolate = bool(_env("RELAXED_EXTRAP"))
    return fused_grad.make_value_and_grad(
        spec.layers, spec.activation, spec.p, spec.kinetic, spec.nonlinearity,
        bc_weight=spec.bc_weight, norm_weight=spec.norm_weight,
        delayed=relaxed, refresh_every=_env_int(refresh_every, "RELAXED_REFRESH"),
        extrapolate=extrapolate, exact_until=_env_int(None, "RELAXED_EXACT_UNTIL"),
        fresh_values=bool(_env("RELAXED_FRESH")), runs=True)


def make_packed_value_and_grad(spec: GPESpec, n_runs: int, device=None,
                               relaxed: bool | None = None,
                               refresh_every: int | None = None,
                               extrapolate: bool | None = None):
    """The fused gradient of the packed ensemble path (the port of JAX's
    `make_packed_value_and_grad`): `packed_value_and_grad` when `packed_eligible`
    and on a CUDA device, else None (as JAX's is None off the TPU).
    The ensemble runs on a run axis of the kernels, not lane-packed; n_runs
    (JAX's runs per kernel, M) only enters the eligibility.
    GPE_TPU_TORCH_NO_FUSED=1 disables it."""
    if _env("NO_FUSED"):
        return None
    if resolve_device(device).type != "cuda" or not packed_eligible(spec, n_runs):
        return None
    return packed_value_and_grad(spec, relaxed, refresh_every, extrapolate)
