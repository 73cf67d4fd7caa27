"""Helmholtz 2D solvers, port of `gpe_tpu/helmholtz/problem.py`.

- square [0,π]²: Δu + k²u = q with the manufactured u* = sin(ax)·sin(by)
  (`forcing="manufactured"`: q = Δu* + k²u*, so u* solves the PDE;
  `forcing="reference"`: q = k²·u*);
- disk r < R: Δu + k²u = 0 with the Bessel boundary data u = Jₙ(kR)cos(nθ)
  (exact interior Jₙ(kr)cos(nθ), scipy on the host);
- the inverse problem: k (and an adaptive boundary weight) are leaves of
  the params dict, trained jointly with the net from solution data.

One forward-Laplacian pass of the net feeds the residual; the boundary
and data terms take the value-only pass. Training is `fit` (Adam) or
`fit_hybrid` (Adam → L-BFGS), then optionally the Levenberg–Marquardt
polish on the residual vector; by autograd, as in the JAX package (no
fused kernel).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from gpe_tpu_torch.device import resolve_device
from gpe_tpu_torch.models import mlp
from gpe_tpu_torch.train.loop import fit


@dataclass(frozen=True)
class HelmholtzSpec:
    domain: str = "square"            # "square" | "circle"
    k: float = 2.0                    # wavenumber (initial value when learnable)
    learnable_k: bool = False
    learnable_bc_scale: bool = False  # the adaptive boundary weight (init 10)
    bc_weight: float = 10.0
    data_weight: float = 1.0
    layers: tuple = (2, 64, 64, 64, 1)
    activation: str = "tanh"
    init_scheme: str = "xavier_uniform"  # "siren" pairs with activation="sin"
    w0: float = 6.0                      # siren first-layer frequency reach
    n_interior: int = 4096
    n_boundary: int = 256
    mode_n: int = 0                   # circle: angular order of the Bessel mode
    radius: float = 1.0
    ab: tuple = (1.0, 1.0)            # square manufactured u* = sin(ax)sin(by)
    forcing: str = "manufactured"     # or "reference" (q = k²·u*)
    lb: float = 0.0
    ub: float = math.pi
    dtype: torch.dtype = torch.float32


def square_exact(spec: HelmholtzSpec, xy: torch.Tensor) -> torch.Tensor:
    """u* = sin(ax)·sin(by) on [0,π]²."""
    a, b = spec.ab
    return torch.sin(a * xy[:, 0]) * torch.sin(b * xy[:, 1])


def circle_exact(spec: HelmholtzSpec, xy) -> np.ndarray:
    """u* = Jₙ(k·r)·cos(nθ), the exact solution in the disk (scipy's Bessel
    on the host, numpy in and out)."""
    from scipy.special import jn
    xy = np.asarray(xy)
    r = np.sqrt(xy[:, 0] ** 2 + xy[:, 1] ** 2)
    th = np.arctan2(xy[:, 1], xy[:, 0])
    return jn(spec.mode_n, spec.k * r) * np.cos(spec.mode_n * th)


def make_helmholtz_batch(spec: HelmholtzSpec, seed: int = 0, device=None) -> dict:
    """Interior collocation points, boundary points with their data and the
    exact interior values on `device` (None → the CUDA card), with an
    80/20 boundary train/test split; numpy's RNG draws the points, so the
    batch is the JAX package's."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if spec.domain == "square":
        lo, hi = spec.lb, spec.ub
        x = rng.uniform(lo, hi, (spec.n_interior, 2)).astype(np.float32)
        t = rng.uniform(lo, hi, (spec.n_boundary,)).astype(np.float32)
        bx = np.concatenate([
            np.stack([t, np.full_like(t, lo)], -1),
            np.stack([t, np.full_like(t, hi)], -1),
            np.stack([np.full_like(t, lo), t], -1),
            np.stack([np.full_like(t, hi), t], -1)], axis=0).astype(np.float32)
        exact = square_exact(spec, torch.from_numpy(bx)).numpy()
        u_exact = square_exact(spec, torch.from_numpy(x)).numpy()
    elif spec.domain == "circle":
        r = spec.radius * np.sqrt(rng.uniform(0, 1, (spec.n_interior,)))
        th = rng.uniform(0, 2 * np.pi, (spec.n_interior,))
        x = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
        tb = rng.uniform(0, 2 * np.pi, (spec.n_boundary * 4,))
        bx = (spec.radius * np.stack([np.cos(tb), np.sin(tb)], -1)).astype(np.float32)
        exact = circle_exact(spec, bx)
        u_exact = circle_exact(spec, x)
    else:
        raise ValueError(f"unknown domain {spec.domain!r}")
    n_b = bx.shape[0]
    split = int(0.8 * n_b)
    perm = rng.permutation(n_b)
    out = {"x": x, "bx": bx[perm[:split]], "bu": exact[perm[:split]],
           "bx_test": bx[perm[split:]], "bu_test": exact[perm[split:]],
           "u_exact": u_exact}
    return {k: torch.as_tensor(np.asarray(v), dtype=spec.dtype).to(dev).contiguous()
            for k, v in out.items()}


def init_helmholtz_params(spec: HelmholtzSpec, seed: int = 0, device=None) -> dict:
    """{"net": MLP params (spec.init_scheme, w0), and with a learnable k
    "k_raw" (init spec.k), with a learnable boundary weight "bc_scale"
    (init 10)}, the net drawn from a CPU torch.Generator seeded by `seed`."""
    dev = resolve_device(device)
    net = mlp.init_mlp(spec.layers, spec.init_scheme, w0=spec.w0,
                       generator=torch.Generator().manual_seed(seed),
                       dtype=spec.dtype, device=dev)
    params = {"net": net}
    if spec.learnable_k:
        params["k_raw"] = torch.tensor(spec.k, dtype=spec.dtype, device=dev)
    if spec.learnable_bc_scale:
        params["bc_scale"] = torch.tensor(10.0, dtype=spec.dtype, device=dev)
    return params


def _forcing(spec: HelmholtzSpec, x: torch.Tensor):
    """q of the PDE from the TRUE wavenumber spec.k (data, never the
    trainable k: otherwise any k satisfies the residual at u = u*)."""
    if spec.domain != "square":
        return 0.0
    a, b = spec.ab
    ustar = torch.sin(a * x[:, 0]) * torch.sin(b * x[:, 1])
    if spec.forcing == "reference":
        return spec.k * spec.k * ustar
    return (spec.k * spec.k - (a * a + b * b)) * ustar


def make_helmholtz_loss(spec: HelmholtzSpec):
    """loss_fn(params, batch, k_in, scale) -> (total, aux): k_in is k for a
    fixed-k problem (ignored when k is learnable); aux["mu"] is k, so
    fit's μ history is the k history."""

    def loss_fn(params, batch, k_in, scale, group=None):
        k = params["k_raw"] if spec.learnable_k else k_in
        n = mlp.mlp_vgl(params["net"], batch["x"], spec.activation)
        r = n.lap + k * k * n.value - _forcing(spec, batch["x"])
        pde = torch.mean(r * r)
        ub_pred = mlp.mlp_apply(params["net"], batch["bx"], spec.activation)
        bc = torch.mean((ub_pred - batch["bu"]) ** 2)
        bc_w = params.get("bc_scale", spec.bc_weight)
        if spec.learnable_bc_scale and "bc_scale" in params:
            # descent on bc_scale·MSE is unbounded below; keep the value
            # but flip its gradient (2·sg(w) − w): the weight ascends toward
            # the hardest constraint (SA-PINN min-max)
            bc_w = 2.0 * bc_w.detach() - bc_w
        data = (torch.mean((n.value - batch["u_exact"]) ** 2) if spec.learnable_k
                else torch.zeros((), dtype=pde.dtype, device=pde.device))
        total = pde + bc_w * bc + spec.data_weight * data
        kk = torch.as_tensor(k, dtype=pde.dtype, device=pde.device)
        aux = {"pde": pde, "boundary": bc, "data": data, "k": kk, "mu": kk,
               "total": total}
        return total, aux

    return loss_fn


def make_helmholtz_residual_fn(spec: HelmholtzSpec):
    """The flat residual vector whose sum of squares is the fixed-weight
    training loss, for train.gauss_newton.make_lm_solver; with a learnable
    k the data residuals are included, so LM refines k jointly with the
    net (a learnable bc_scale has zero Jacobian here and stays put)."""

    def rfn(params, batch, k_in, scale):
        k = params["k_raw"] if spec.learnable_k else k_in
        n = mlp.mlp_vgl(params["net"], batch["x"], spec.activation)
        r_pde = (n.lap + k * k * n.value - _forcing(spec, batch["x"])) \
            / math.sqrt(1.0 * n.value.shape[0])
        ub_pred = mlp.mlp_apply(params["net"], batch["bx"], spec.activation)
        r_bc = math.sqrt(spec.bc_weight / batch["bx"].shape[0]) * (ub_pred - batch["bu"])
        parts = [r_pde.reshape(-1), r_bc.reshape(-1)]
        if spec.learnable_k:
            r_d = math.sqrt(spec.data_weight / n.value.shape[0]) * (
                n.value - batch["u_exact"])
            parts.append(r_d.reshape(-1))
        return torch.cat(parts)

    return rfn


class HelmholtzResult(NamedTuple):
    params: any
    k: float
    test_mae: float
    interior_mse: float
    loss_history: np.ndarray
    k_error: float = 0.0       # |k_learned − k_true| (inverse problem)
    seconds: dict = None       # {"adam", "lbfgs", "lm"}


def train_helmholtz(spec: HelmholtzSpec, epochs: int = 4000, lr: float = 1e-3,
                    seed: int = 0, check_every: int = 1000,
                    lbfgs_steps: int = 0, lm_steps: int = 0,
                    lm_cg_iters: int = 80, device=None) -> HelmholtzResult:
    """Adam (clip 1.0), or with lbfgs_steps > 0 Adam then L-BFGS
    (`fit_hybrid`), then with lm_steps > 0 the Levenberg–Marquardt polish
    of the residual, on `device` (None → the CUDA card)."""
    from gpe_tpu_torch.train.gauss_newton import make_lm_solver
    from gpe_tpu_torch.train.hybrid import fit_hybrid
    from gpe_tpu_torch.train.optimizers import make_optimizer

    dev = resolve_device(device)
    batch = make_helmholtz_batch(spec, seed, device=dev)
    loss_fn = make_helmholtz_loss(spec)
    params = init_helmholtz_params(spec, seed, device=dev)
    if lbfgs_steps > 0:
        hr = fit_hybrid(loss_fn, params, batch, spec.k, 1.0, adam_epochs=epochs,
                        adam_lr=lr, lbfgs_steps=lbfgs_steps, clip_norm=1.0,
                        check_every=check_every)
        params, hist, seconds = hr.params, hr.adam.loss_history, dict(hr.seconds)
    else:
        t0 = time.perf_counter()
        res = fit(loss_fn, make_optimizer("adam", lr, clip_norm=1.0), params, batch,
                  spec.k, 1.0, epochs=epochs, tol=0.0, patience=10**9,
                  check_every=check_every)
        params, hist, seconds = res.params, res.loss_history, {"adam": time.perf_counter() - t0}
    k32 = torch.tensor(spec.k, dtype=torch.float32, device=dev)
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    if lm_steps > 0:
        t0 = time.perf_counter()
        lm = make_lm_solver(make_helmholtz_residual_fn(spec), params, steps=lm_steps,
                            cg_iters=lm_cg_iters)
        params = lm(params, batch, k32, one).params
        seconds["lm"] = time.perf_counter() - t0
    with torch.no_grad():
        _, aux = loss_fn(params, batch, k32, one)
        test_pred = mlp.mlp_apply(params["net"], batch["bx_test"], spec.activation)
        test_mae = float(torch.mean(torch.abs(test_pred - batch["bu_test"])))
        interior = mlp.mlp_apply(params["net"], batch["x"], spec.activation)
        interior_mse = float(torch.mean((interior - batch["u_exact"]) ** 2))
    k = float(aux["k"])
    return HelmholtzResult(params, k, test_mae, interior_mse, np.asarray(hist),
                           k_error=abs(k - spec.k), seconds=seconds)
