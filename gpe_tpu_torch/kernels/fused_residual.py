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

`compute_dtype=torch.bfloat16` is the port of
`make_pallas_loss_eval(compute_dtype=bf16)`: every GEMM operand (weights,
channel state, layer 0's x) is rounded to bf16, round-to-nearest-even,
before its product; products and sums stay f32, as do biases, activations,
the Hamiltonian and the reductions. Its plain version rounds the same
operands with `.to(torch.bfloat16).float()` (`fwdlap_mlp_bf16`). The run
mode takes it too (K2's bf16 run-mode vag starts from these sums); the
eval entry `make_loss_eval` keeps its run mode f32.
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
from gpe_tpu_torch.ops.laplacian import activation_triple, fwdlap_mlp
from gpe_tpu_torch.ops.rayleigh import hamiltonian_apply
from gpe_tpu_torch.physics.bases import ValGradLap

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_compute_dtype(compute_dtype) -> bool:
    """True for the bf16 operand mode; raises on a type the kernels lack."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, "
                         f"got {compute_dtype}")
    return compute_dtype == torch.bfloat16


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (nearest even), in t's dtype: a float64 run of a
    bf16 plain version rounds the same operands."""
    return t.to(torch.bfloat16).to(t.dtype)


def fwdlap_mlp_bf16(params, x: torch.Tensor, activation: str = "tanh") -> ValGradLap:
    """fwdlap_mlp (scalar output) with both operands of every layer's GEMM
    rounded to bf16 first; the product and its sum run in f32, the bias and
    the activation recursion too. Layer 0's Jacobian rows are then the
    rounded rows of W0."""
    act = activation_triple(activation)
    N, d = x.shape
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    s = torch.cat([x[:, None, :], eye.expand(N, d, d),
                   torch.zeros(N, 1, d, dtype=x.dtype, device=x.device)], dim=1)
    for li, (w, b) in enumerate(params):
        s = torch.matmul(_bf16(s), _bf16(w))
        s = torch.cat([s[:, :1] + b, s[:, 1:]], dim=1)
        if li < len(params) - 1:
            val, d1, d2 = act(s[:, 0, :])
            jac, lap = s[:, 1:1 + d, :], s[:, 1 + d, :]
            lap = d1 * lap + d2 * torch.sum(jac * jac, dim=1)
            s = torch.cat([val[:, None], d1[:, None] * jac, lap[:, None]], dim=1)
    return ValGradLap(s[:, 0, 0], s[:, 1:1 + d, 0], s[:, 1 + d, 0])


def collocation_sums_plain(params, x, V, w, gamma, scale, base_val=None,
                           base_lap=None, activation: str = "tanh",
                           p: float = 3.0, kinetic: float = 1.0,
                           nonlinearity: str = "abs_power",
                           compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch K1: the four sums as a (4,) tensor."""
    bf16 = check_compute_dtype(compute_dtype)
    net = (fwdlap_mlp_bf16 if bf16 else fwdlap_mlp)(params, x, activation)
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
                                nonlinearity: str = "abs_power",
                                compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch K1 run mode: the plain K1 of each run, as (R, 4) —
    the definition of R independent runs."""
    R = params[0][0].shape[0]
    gs, ss = _per_run(gamma, R), _per_run(scale, R)
    return torch.stack([
        collocation_sums_plain(run_slice(params, r), x, V, w, gs[r], ss[r],
                               _row(base_val, r), _row(base_lap, r), activation,
                               p, kinetic, nonlinearity, compute_dtype)
        for r in range(R)])


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gpe_k1_sums_runs.argtypes = [P, P, P, P, I, P, I, P, ctypes.POINTER(I),
                                     I, I, I, I, F, F, P, I, I, P, I, P, I, P]
    lib.gpe_k1_sums_runs.restype = I


def _launch(params, x, V, w, scal, base_val, base_lap, activation, p, kinetic,
            nonlinearity, n_runs, bf16=False):
    """One launch of csrc/fused_residual.cu for n_runs run-stacked nets (None:
    one net; bf16: the bf16 operand mode); returns the (R, 4) sums."""
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
        int(bf16), stream)
    _build.check(lib, rc, "gpe_k1_sums_runs")
    return out


def collocation_sums(params, x, V, w, gamma, scale, base_val=None,
                     base_lap=None, activation: str = "tanh", p: float = 3.0,
                     kinetic: float = 1.0, nonlinearity: str = "abs_power",
                     compute_dtype=torch.float32) -> torch.Tensor:
    """The four sums: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. γ and scale may be numbers or device scalars. Launches
    count in `collocation_sums.launches` (f32) and `.bf16_launches`."""
    bf16 = check_compute_dtype(compute_dtype)
    if x.device.type == "cpu":
        return collocation_sums_plain(params, x, V, w, gamma, scale, base_val,
                                      base_lap, activation, p, kinetic,
                                      nonlinearity, compute_dtype)
    out = _launch(params, x, V, w, run_scalars(x.device, 1, gamma, scale),
                  base_val, base_lap, activation, p, kinetic, nonlinearity, None,
                  bf16)
    if bf16:
        collocation_sums.bf16_launches += 1
    else:
        collocation_sums.launches += 1
    return out[0]


collocation_sums.launches = 0
collocation_sums.bf16_launches = 0


def collocation_sums_runs(params, x, V, w, gamma, scale, base_val=None,
                          base_lap=None, activation: str = "tanh",
                          p: float = 3.0, kinetic: float = 1.0,
                          nonlinearity: str = "abs_power",
                          compute_dtype=torch.float32) -> torch.Tensor:
    """(R, 4) sums of R run-stacked nets in one launch: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. γ and scale: numbers,
    0-d or (R,) tensors; base_val/base_lap: None, (n,) shared or (R, n).
    Launches count in `.launches` (f32) and `.bf16_launches`."""
    bf16 = check_compute_dtype(compute_dtype)
    if x.device.type == "cpu":
        return collocation_sums_runs_plain(params, x, V, w, gamma, scale,
                                           base_val, base_lap, activation, p,
                                           kinetic, nonlinearity, compute_dtype)
    R = params[0][0].shape[0]
    out = _launch(params, x, V, w, run_scalars(x.device, R, gamma, scale),
                  base_val, base_lap, activation, p, kinetic, nonlinearity, R, bf16)
    if bf16:
        collocation_sums_runs.bf16_launches += 1
    else:
        collocation_sums_runs.launches += 1
    return out


collocation_sums_runs.launches = 0
collocation_sums_runs.bf16_launches = 0


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


def sums_to_total(params, batch, scale, sums, activation, bc_weight,
                  norm_weight):
    """(total, aux) of the full GPE loss from the four collocation sums and
    a plain forward over the boundary points (K1's and K4's eval_fn)."""
    mu, pde, norm, _ = sums_to_loss(sums, batch["x"].shape[0], norm_weight)
    bv = scale_rows(mlp_apply(params, batch["bx"], activation), scale)
    if "base_bval" in batch:
        bv = batch["base_bval"] + bv
    boundary = torch.mean(bv * bv, dim=-1)
    total = pde + bc_weight * boundary + norm_weight * norm
    return total, {"pde": pde, "boundary": boundary, "norm": norm, "mu": mu,
                   "total": total}


def make_loss_eval(layers, activation: str = "tanh", p: float = 3.0,
                   kinetic: float = 1.0, nonlinearity: str = "abs_power",
                   bc_weight: float = 10.0, norm_weight: float = 20.0,
                   runs: bool = False, compute_dtype=torch.float32):
    """eval_fn(params, batch, gamma, scale) -> (total, aux): the full GPE
    loss with K1 for the collocation terms and a plain forward for the
    boundary term (the port of make_pallas_loss_eval). runs=True is its
    n_runs > 1 mode: run-stacked params, γ/scale per run, the batch's base
    arrays shared or per run ((R, n), (R, B)); total and aux are (R,).
    compute_dtype=torch.bfloat16 is the bf16 operand mode (single runs)."""
    if layers[-1] != 1:
        raise ValueError("scalar-output nets only")
    if check_compute_dtype(compute_dtype) and runs:
        raise ValueError("the run mode is f32 only, as in the JAX package")
    kw = dict(activation=activation, p=p, kinetic=kinetic,
              nonlinearity=nonlinearity)
    if not runs:
        kw["compute_dtype"] = compute_dtype
    sums_fn = collocation_sums_runs if runs else collocation_sums

    def eval_fn(params, batch, gamma, scale):
        sums = sums_fn(params, batch["x"], batch["V"], batch["w"], gamma, scale,
                       batch.get("base_val"), batch.get("base_lap"), **kw)
        return sums_to_total(params, batch, scale, sums, activation, bc_weight,
                             norm_weight)

    return eval_fn
