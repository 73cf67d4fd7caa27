"""K1 — the fused GPE collocation sums, port of `gpe_tpu/pallas/fused_residual.py`.

`collocation_sums` returns S = (Σ(Hu)², Σu·Hu, Σu², Σu²w) for
u = base + scale·net(x), Hu = −c·Δu + V·u + γ𝒩(u). On CUDA tensors it
launches the hand-written kernel `csrc/fused_residual.cu`; on CPU tensors it
takes `collocation_sums_plain` (fwdlap_mlp + the Hamiltonian + four sums),
the yardstick the kernel is held against. From S: μ = S₁/S₂,
pde = (S₀ − 2μS₁ + μ²S₂)/N, norm = (S₃ − 1)².
"""
from __future__ import annotations

import ctypes

import torch

from gpe_tpu_torch.kernels import _build
from gpe_tpu_torch.kernels._common import (ACT_CODES, NONLIN_CODES, check_inputs,
                                           dims_array, kernel_supports, n_blocks,
                                           pack_params, ptr, scalars)
from gpe_tpu_torch.models.mlp import mlp_apply
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


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gpe_k1_sums.argtypes = [P, P, P, P, P, P, ctypes.POINTER(I), I, I, I,
                                I, F, F, P, P, I, P, P]
    lib.gpe_k1_sums.restype = I


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
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, layers = check_inputs(params, x, V, w, base_val, base_lap)
    if not kernel_supports(layers, activation) or nonlinearity not in NONLIN_CODES:
        raise ValueError(f"K1 does not take layers={layers}, "
                         f"activation={activation!r}, nonlinearity={nonlinearity!r}")
    lib = _build.library("fused_residual", _bind)
    dev = x.device
    prm = pack_params(params)
    scal = scalars(dev, gamma, scale)
    P = n_blocks(dev)
    partial = torch.empty(P * 4, dtype=torch.float32, device=dev)
    out = torch.empty(4, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gpe_k1_sums(
        ptr(x), ptr(V), ptr(w), ptr(base_val), ptr(base_lap), ptr(prm),
        dims_array(layers), len(layers) - 1, n, ACT_CODES[activation],
        NONLIN_CODES[nonlinearity], float(p), float(kinetic), ptr(scal),
        ptr(partial), P, ptr(out), stream)
    _build.check(lib, rc, "gpe_k1_sums")
    collocation_sums.launches += 1
    return out


collocation_sums.launches = 0


def sums_to_loss(sums: torch.Tensor, n: int, norm_weight: float):
    """(μ, pde, norm, cotangents ∂L/∂S) from the four sums, where
    L = pde + norm_weight·norm (the collocation part of the loss)."""
    s0, s1, s2, s3 = sums[0], sums[1], sums[2], sums[3]
    mu = s1 / (s2 + 1e-12)
    pde = (s0 - 2.0 * mu * s1 + mu * mu * s2) / n
    norm = (s3 - 1.0) ** 2
    cots = torch.stack([torch.full_like(mu, 1.0 / n), -2.0 * mu / n,
                        mu * mu / n, 2.0 * norm_weight * (s3 - 1.0)])
    return mu, pde, norm, cots


def make_loss_eval(layers, activation: str = "tanh", p: float = 3.0,
                   kinetic: float = 1.0, nonlinearity: str = "abs_power",
                   bc_weight: float = 10.0, norm_weight: float = 20.0):
    """eval_fn(params, batch, gamma, scale) -> (total, aux): the full GPE
    loss with K1 for the collocation terms and a plain forward for the
    boundary term (the port of make_pallas_loss_eval, one run)."""
    if layers[-1] != 1:
        raise ValueError("scalar-output nets only")

    def eval_fn(params, batch, gamma, scale):
        x = batch["x"]
        sums = collocation_sums(params, x, batch["V"], batch["w"], gamma,
                                scale, batch.get("base_val"),
                                batch.get("base_lap"), activation, p, kinetic,
                                nonlinearity)
        mu, pde, norm, _ = sums_to_loss(sums, x.shape[0], norm_weight)
        bv = mlp_apply(params, batch["bx"], activation) * scale
        if "base_bval" in batch:
            bv = batch["base_bval"] + bv
        boundary = torch.mean(bv * bv)
        total = pde + bc_weight * boundary + norm_weight * norm
        return total, {"pde": pde, "boundary": boundary, "norm": norm,
                       "mu": mu, "total": total}

    return eval_fn
