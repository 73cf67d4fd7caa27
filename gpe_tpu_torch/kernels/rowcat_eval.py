"""K4 — the channel-stacked ("rowcat") fused loss eval, port of
`gpe_tpu/pallas/rowcat_eval.py`.

The same four sums as K1 at one run, S = (Σ(Hu)², Σu·Hu, Σu², Σu²w), from
its own CUDA kernel `csrc/rowcat_eval.cu` (entry `gpe_k4_sums`): the C = d+2
channels of 2T points are stacked into a 256-row block, so each hidden layer
is one 256-row GEMM (K1's block has 128 rows). On CPU tensors the wrapper
takes the plain version. Scope as in JAX: one run, scalar output, hidden
widths ≤ 128, at least one hidden layer, base streams of shape (n,).
"""
from __future__ import annotations

import ctypes

import torch

from gpe_tpu_torch.kernels import _build
from gpe_tpu_torch.kernels import fused_residual as k1
from gpe_tpu_torch.kernels._common import (ACT_CODES, MAXW, NONLIN_CODES,
                                           check_inputs, device_buffer,
                                           dims_array, kernel_supports,
                                           pack_params, ptr, run_scalars)


def collocation_sums_plain(params, x, V, w, gamma, scale, base_val=None,
                           base_lap=None, activation: str = "tanh",
                           p: float = 3.0, kinetic: float = 1.0,
                           nonlinearity: str = "abs_power",
                           compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch K4, f32 or with bf16 GEMM operands: K4 computes K1's
    function, so this is K1's plain version (fwdlap_mlp or fwdlap_mlp_bf16,
    the Hamiltonian and the four sums) as a (4,) tensor."""
    return k1.collocation_sums_plain(params, x, V, w, gamma, scale, base_val,
                                     base_lap, activation, p, kinetic,
                                     nonlinearity, compute_dtype)


def check_scope(layers, activation: str, nonlinearity: str) -> None:
    """Refuse what K4 does not take (the JAX asserts, plus the kernel's
    d ≤ 3 and activations)."""
    layers = tuple(layers)
    if layers[-1] != 1:
        raise ValueError("scalar-output nets only")
    if len(layers) < 3:
        raise ValueError("the rowcat kernel needs at least one hidden layer")
    if any(h > MAXW for h in layers[1:-1]):
        raise ValueError("rowcat hidden widths must be <= 128")
    if not kernel_supports(layers, activation) or nonlinearity not in NONLIN_CODES:
        raise ValueError(f"K4 does not take layers={layers}, "
                         f"activation={activation!r}, nonlinearity={nonlinearity!r}")


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gpe_k4_sums.argtypes = [P, P, P, P, P, P, P, ctypes.POINTER(I), I, I, I,
                                I, F, F, P, I, P, I, P, P]
    lib.gpe_k4_sums.restype = I


def pad_hidden(params, bf16: bool = False) -> torch.Tensor:
    """The hidden GEMM layers' weights W_1 .. W_{L-2}, each zero-padded to
    (K, 128) columns (JAX's _pad_params pads every layer to 128 lanes) and,
    in the bf16 mode, rounded to bf16 values (`_pad_params(w_dtype=bf16)`),
    laid end to end: the kernel copies them per tile with cp.async, as is."""
    hidden = [W for W, _ in params[1:-1]]
    if not hidden:
        return torch.zeros(4, dtype=torch.float32, device=params[0][0].device)
    flat = torch.cat([torch.nn.functional.pad(W, (0, MAXW - W.shape[1])).reshape(-1)
                      for W in hidden])
    return flat.to(torch.bfloat16).float() if bf16 else flat


def _launch(params, x, V, w, gamma, scale, base_val, base_lap, activation, p,
            kinetic, nonlinearity, bf16):
    """One launch of csrc/rowcat_eval.cu; returns the (4,) sums. The grid is
    the kernel's own: min(SM count, tiles of 2·(128 // (d+2)) points)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, layers = check_inputs(params, x, V, w, base_val, base_lap)
    check_scope(layers, activation, nonlinearity)
    lib = _build.library("rowcat_eval", _bind)
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-n // (2 * (MAXW // (layers[0] + 2))))
    G = max(1, min(sms, tiles))
    partial = device_buffer(dev, G * 4, "K4 partial sums")
    out = torch.empty(4, dtype=torch.float32, device=dev)
    scal = run_scalars(dev, 1, gamma, scale)
    prm, wpad = pack_params(params), pad_hidden(params, bf16)
    rc = lib.gpe_k4_sums(
        ptr(x), ptr(V), ptr(w), ptr(base_val), ptr(base_lap), ptr(prm), ptr(wpad),
        dims_array(layers), len(layers) - 1, n,
        ACT_CODES[activation], NONLIN_CODES[nonlinearity], float(p),
        float(kinetic), ptr(scal), int(bf16), ptr(partial), G, ptr(out),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "gpe_k4_sums")
    return out


def collocation_sums(params, x, V, w, gamma, scale, base_val=None,
                     base_lap=None, activation: str = "tanh", p: float = 3.0,
                     kinetic: float = 1.0, nonlinearity: str = "abs_power",
                     compute_dtype=torch.float32) -> torch.Tensor:
    """The four sums as a (4,) tensor: K4's CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Launches count in
    `collocation_sums.launches` (f32) and `.bf16_launches`."""
    bf16 = k1.check_compute_dtype(compute_dtype)
    if x.device.type == "cpu":
        check_scope([x.shape[1]] + [W.shape[-1] for W, _ in params], activation,
                    nonlinearity)
        return collocation_sums_plain(params, x, V, w, gamma, scale, base_val,
                                      base_lap, activation, p, kinetic,
                                      nonlinearity, compute_dtype)
    out = _launch(params, x, V, w, gamma, scale, base_val, base_lap, activation,
                  p, kinetic, nonlinearity, bf16)
    if bf16:
        collocation_sums.bf16_launches += 1
    else:
        collocation_sums.launches += 1
    return out


collocation_sums.launches = 0
collocation_sums.bf16_launches = 0


def make_rowcat_loss_eval(layers, activation: str = "tanh", p: float = 3.0,
                          kinetic: float = 1.0, nonlinearity: str = "abs_power",
                          bc_weight: float = 10.0, norm_weight: float = 20.0,
                          tile: int = 1792, compute_dtype=torch.float32):
    """eval_fn(params, batch, gamma, scale) -> (total, aux) with K4 for the
    collocation sums and a plain forward for the boundary term; the contract
    of K1's make_loss_eval at one run. `eval_fn.collocation_sums(params, x,
    V, w, gamma, scale, base_val=None, base_lap=None)` returns the (4,) sums.

    `tile` keeps its JAX contract and nothing more: a point count n that it
    does not divide is refused with a ValueError (JAX asserts). The card's
    launch geometry is the kernel's own — carrying the Pallas grid over
    (n/tile = 28 blocks at tile 1792 and 50,176 points) would leave 104 of
    the H100's 132 SMs idle."""
    check_scope(layers, activation, nonlinearity)
    k1.check_compute_dtype(compute_dtype)

    def sums_fn(params, x, V, w, gamma, scale, base_val=None, base_lap=None):
        n = x.shape[0]
        if n % tile:
            raise ValueError(f"collocation count {n} must be divisible by "
                             f"tile={tile}")
        return collocation_sums(params, x, V, w, gamma, scale, base_val,
                                base_lap, activation, p, kinetic, nonlinearity,
                                compute_dtype)

    def eval_fn(params, batch, gamma, scale):
        sums = sums_fn(params, batch["x"], batch["V"], batch["w"], gamma, scale,
                       batch.get("base_val"), batch.get("base_lap"))
        return k1.sums_to_total(params, batch, scale, sums, activation,
                                bc_weight, norm_weight)

    eval_fn.collocation_sums = sums_fn
    return eval_fn
