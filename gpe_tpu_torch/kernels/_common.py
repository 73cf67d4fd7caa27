"""Host-side helpers shared by the kernel wrappers: argument checks, the
flat parameter packing, and the codes the C entry points take."""
from __future__ import annotations

import ctypes

import torch

MAXW = 128                   # widest layer the kernels take (csrc/common.cuh)
MAX_LAYERS = 8
ACT_CODES = {"tanh": 0, "shifted_tanh": 1, "sin": 2}
NONLIN_CODES = {"abs_power": 0, "power": 1}


def kernel_supports(layers, activation: str) -> bool:
    """True when the CUDA kernels take this net: 1 ≤ d ≤ 3 inputs, hidden
    widths ≤ 128, 1–7 hidden layers, scalar output, an activation with a σ‴
    rule in the kernels."""
    layers = tuple(layers)
    return (len(layers) >= 3 and len(layers) - 1 <= MAX_LAYERS
            and 1 <= layers[0] <= 3 and layers[-1] == 1
            and all(1 <= h <= MAXW for h in layers[1:-1])
            and activation in ACT_CODES)


def check_inputs(params, x, V, w, base_val, base_lap):
    """Device, dtype, shape and contiguity checks for a kernel launch."""
    dev = x.device
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"x must be (n, d) float32, got {tuple(x.shape)} {x.dtype}")
    n = x.shape[0]
    for name, t in (("V", V), ("w", w), ("base_val", base_val),
                    ("base_lap", base_lap)):
        if t is None and name.startswith("base"):
            continue
        if t.device != dev or t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{name} must be ({n},) float32 on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    layers = [params[0][0].shape[0]] + [W.shape[1] for W, _ in params]
    for li, (W, b) in enumerate(params):
        if (W.device != dev or b.device != dev or W.dtype != torch.float32
                or b.dtype != torch.float32):
            raise ValueError(f"layer {li} params must be float32 on {dev}")
        if W.shape != (layers[li], layers[li + 1]) or b.shape != (layers[li + 1],):
            raise ValueError(f"layer {li}: W {tuple(W.shape)}, b {tuple(b.shape)} "
                             f"do not chain with the widths {layers}")
    if layers[0] != x.shape[1]:
        raise ValueError(f"net input width {layers[0]} != d = {x.shape[1]}")
    return n, layers


def pack_params(params) -> torch.Tensor:
    """Flat (W0, b0, W1, b1, ...) buffer, each W row-major (in, out)."""
    return torch.cat([t.reshape(-1) for W, b in params for t in (W, b)])


def unpack_flat(flat: torch.Tensor, layers):
    """Inverse of pack_params for the given widths: a tuple of (W, b) views."""
    out, off = [], 0
    for k, n in zip(layers[:-1], layers[1:]):
        W = flat[off:off + k * n].view(k, n)
        off += k * n
        b = flat[off:off + n]
        off += n
        out.append((W, b))
    return tuple(out)


def dims_array(layers):
    return (ctypes.c_int * len(layers))(*layers)


def ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def n_blocks(device: torch.device) -> int:
    """P persistent blocks: one per SM (the kernels use ~200 KB of shared
    memory, so one block fits an SM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def scalars(device, *vals) -> torch.Tensor:
    """The kernels' device-side scalars, built without a host round trip
    (Python numbers go in as fill values, tensors stay on the device)."""
    return torch.stack([
        v.to(device=device, dtype=torch.float32).reshape(())
        if isinstance(v, torch.Tensor)
        else torch.full((), float(v), dtype=torch.float32, device=device)
        for v in vals])
