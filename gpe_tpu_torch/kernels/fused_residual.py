"""K1 — the fused GPE collocation sums, port of `gpe_tpu/pallas/fused_residual.py`,
and its run mode (K3, the port of `n_runs = M > 1`).

`collocation_sums` returns S = (Σ(Hu)², Σu·Hu, Σu², Σu²w) for
u = base + scale·net(x), Hu = −c·Δu + V·u + γ𝒩(u). On CUDA tensors it
launches the hand-written kernel `csrc/fused_residual.cu`; on CPU tensors it
takes `collocation_sums_plain` (fwdlap_mlp + the Hamiltonian + four sums),
the yardstick the kernel is held against. From S: μ = S₁/S₂,
pde = (S₀ − 2μS₁ + μ²S₂)/N, norm = (S₃ − 1)².

`collocation_sums_runs` is the same function for R independent runs in one
launch: run-stacked params (a leading run axis on every leaf), γ and scale
per run, each base shared (n,) or per run (R, n); it returns (R, 4). Its
plain version loops the plain K1 over the runs. The JAX package packs M runs
block-diagonally into one 128-lane net (`gpe_tpu/pallas/packing.py`); the
port keeps the runs apart on a run axis of the launch, and
`kernels/packing.py` converts between the two layouts.
"""
from __future__ import annotations

import ctypes

import torch

from gpe_tpu_torch.kernels import _build
from gpe_tpu_torch.kernels._common import (ACT_CODES, NONLIN_CODES, base_stride,
                                           check_inputs, device_buffer,
                                           dims_array, kernel_supports,
                                           launch_geometry, pack_params, ptr,
                                           run_scalars, scale_rows)
from gpe_tpu_torch.models.mlp import mlp_apply, run_slice
from gpe_tpu_torch.ops.laplacian import fwdlap_mlp
from gpe_tpu_torch.ops.rayleigh import hamiltonian_apply


def collocation_sums_plain(params, x, V, w, gamma, scale, base_val=None,
                           base_lap=None, activation: str = "tanh",
                           p: float = 3.0, kinetic: float = 1.0,
                           nonlinearity: str = "abs_power") -> torch.Tensor:
    """Plain PyTorch K1: the four sums as a (4,) tensor."""
    net = fwdlap_mlp(params, x, activation)
    u = scale * net.value
    lap = scale * net.lap
    if base_val is not None:
        u = base_val + u
    if base_lap is not None:
        lap = base_lap + lap
    hu = hamiltonian_apply(u, lap, V, gamma, p, kinetic, nonlinearity)
    return torch.stack([torch.sum(hu * hu), torch.sum(u * hu),
                        torch.sum(u * u), torch.sum(u * u * w)])


def _row(base, r):
    return base if base is None or base.ndim == 1 else base[r]


def _per_run(v, n_runs: int) -> list:
    """A number, 0-d tensor or (R,) tensor as a list of R per-run values."""
    if isinstance(v, torch.Tensor) and v.ndim:
        return list(v.unbind(0))
    return [v] * n_runs


def collocation_sums_runs_plain(params, x, V, w, gamma, scale, base_val=None,
                                base_lap=None, activation: str = "tanh",
                                p: float = 3.0, kinetic: float = 1.0,
                                nonlinearity: str = "abs_power") -> torch.Tensor:
    """Plain PyTorch K1 run mode: the plain K1 of each run, as (R, 4) —
    the definition of R independent runs."""
    R = params[0][0].shape[0]
    gs, ss = _per_run(gamma, R), _per_run(scale, R)
    return torch.stack([
        collocation_sums_plain(run_slice(params, r), x, V, w, gs[r], ss[r],
                               _row(base_val, r), _row(base_lap, r), activation,
                               p, kinetic, nonlinearity)
        for r in range(R)])


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gpe_k1_sums_runs.argtypes = [P, P, P, P, I, P, I, P, ctypes.POINTER(I),
                                     I, I, I, I, F, F, P, I, I, P, I, P, P]
    lib.gpe_k1_sums_runs.restype = I


def _launch(params, x, V, w, scal, base_val, base_lap, activation, p, kinetic,
            nonlinearity, n_runs):
    """One launch of csrc/fused_residual.cu for n_runs run-stacked nets (None:
    one net); returns the (R, 4) sums."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, layers = check_inputs(params, x, V, w, base_val, base_lap, n_runs)
    if not kernel_supports(layers, activation) or nonlinearity not in NONLIN_CODES:
        raise ValueError(f"K1 does not take layers={layers}, "
                         f"activation={activation!r}, nonlinearity={nonlinearity!r}")
    lib = _build.library("fused_residual", _bind)
    dev = x.device
    R = n_runs or 1
    prm = pack_params(params, n_runs)
    S, G = launch_geometry(dev, n, layers[0], R)
    partial = device_buffer(dev, R * S * 4, "K1 partial sums")
    out = torch.empty((R, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gpe_k1_sums_runs(
        ptr(x), ptr(V), ptr(w), ptr(base_val), base_stride(base_val),
        ptr(base_lap), base_stride(base_lap), ptr(prm), dims_array(layers),
        len(layers) - 1, n, ACT_CODES[activation], NONLIN_CODES[nonlinearity],
        float(p), float(kinetic), ptr(scal), R, S, ptr(partial), G, ptr(out),
        stream)
    _build.check(lib, rc, "gpe_k1_sums_runs")
    return out


def collocation_sums(params, x, V, w, gamma, scale, base_val=None,
                     base_lap=None, activation: str = "tanh", p: float = 3.0,
                     kinetic: float = 1.0,
                     nonlinearity: str = "abs_power") -> torch.Tensor:
    """The four sums: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. γ and scale may be numbers or device scalars."""
    if x.device.type == "cpu":
        return collocation_sums_plain(params, x, V, w, gamma, scale, base_val,
                                      base_lap, activation, p, kinetic,
                                      nonlinearity)
    out = _launch(params, x, V, w, run_scalars(x.device, 1, gamma, scale),
                  base_val, base_lap, activation, p, kinetic, nonlinearity, None)
    collocation_sums.launches += 1
    return out[0]


collocation_sums.launches = 0


def collocation_sums_runs(params, x, V, w, gamma, scale, base_val=None,
                          base_lap=None, activation: str = "tanh",
                          p: float = 3.0, kinetic: float = 1.0,
                          nonlinearity: str = "abs_power") -> torch.Tensor:
    """(R, 4) sums of R run-stacked nets in one launch: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. γ and scale: numbers,
    0-d or (R,) tensors; base_val/base_lap: None, (n,) shared or (R, n)."""
    if x.device.type == "cpu":
        return collocation_sums_runs_plain(params, x, V, w, gamma, scale,
                                           base_val, base_lap, activation, p,
                                           kinetic, nonlinearity)
    R = params[0][0].shape[0]
    out = _launch(params, x, V, w, run_scalars(x.device, R, gamma, scale),
                  base_val, base_lap, activation, p, kinetic, nonlinearity, R)
    collocation_sums_runs.launches += 1
    return out


collocation_sums_runs.launches = 0


def sums_to_loss(sums: torch.Tensor, n: int, norm_weight: float):
    """(μ, pde, norm, cotangents ∂L/∂S) from the four sums (…, 4), where
    L = pde + norm_weight·norm (the collocation part of the loss); run-mode
    (R, 4) sums give (R,) values and (R, 4) cotangents."""
    s0, s1, s2, s3 = sums.unbind(-1)
    mu = s1 / (s2 + 1e-12)
    pde = (s0 - 2.0 * mu * s1 + mu * mu * s2) / n
    norm = (s3 - 1.0) ** 2
    cots = torch.stack([torch.full_like(mu, 1.0 / n), -2.0 * mu / n,
                        mu * mu / n, 2.0 * norm_weight * (s3 - 1.0)], dim=-1)
    return mu, pde, norm, cots


def make_loss_eval(layers, activation: str = "tanh", p: float = 3.0,
                   kinetic: float = 1.0, nonlinearity: str = "abs_power",
                   bc_weight: float = 10.0, norm_weight: float = 20.0,
                   runs: bool = False):
    """eval_fn(params, batch, gamma, scale) -> (total, aux): the full GPE
    loss with K1 for the collocation terms and a plain forward for the
    boundary term (the port of make_pallas_loss_eval). runs=True is its
    n_runs > 1 mode: run-stacked params, γ/scale per run, the batch's base
    arrays shared or per run ((R, n), (R, B)); total and aux are (R,)."""
    if layers[-1] != 1:
        raise ValueError("scalar-output nets only")
    sums_fn = collocation_sums_runs if runs else collocation_sums

    def eval_fn(params, batch, gamma, scale):
        x = batch["x"]
        sums = sums_fn(params, x, batch["V"], batch["w"], gamma, scale,
                       batch.get("base_val"), batch.get("base_lap"), activation,
                       p, kinetic, nonlinearity)
        mu, pde, norm, _ = sums_to_loss(sums, x.shape[0], norm_weight)
        bv = scale_rows(mlp_apply(params, batch["bx"], activation), scale)
        if "base_bval" in batch:
            bv = batch["base_bval"] + bv
        boundary = torch.mean(bv * bv, dim=-1)
        total = pde + bc_weight * boundary + norm_weight * norm
        return total, {"pde": pde, "boundary": boundary, "norm": norm,
                       "mu": mu, "total": total}

    return eval_fn
