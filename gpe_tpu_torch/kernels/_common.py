"""Host-side helpers shared by the kernel wrappers: argument checks, the
flat parameter packing, the codes the C entry points take, and the launch
counters read as differences (`LaunchCounter`)."""
from __future__ import annotations

import ctypes

import torch

MAXW = 128                   # widest layer the kernels take (csrc/common.cuh)
MAX_LAYERS = 8
ACT_CODES = {"tanh": 0, "shifted_tanh": 1, "sin": 2}
NONLIN_CODES = {"abs_power": 0, "power": 1}


class LaunchCounter:
    """The f32 launch counters of K1 and K2 (`collocation_sums.launches`,
    `collocation_grads.launches`) and, with runs=True, of their run mode
    (K3: `collocation_sums_runs`, `collocation_grads_runs`), read as
    differences from the last `mark()`."""

    def __init__(self, runs: bool = False):
        from gpe_tpu_torch.kernels import fused_grad, fused_residual
        self.kernels = {"fused_residual": fused_residual.collocation_sums,
                        "fused_grad": fused_grad.collocation_grads}
        if runs:
            self.kernels.update(fused_residual_runs=fused_residual.collocation_sums_runs,
                                fused_grad_runs=fused_grad.collocation_grads_runs)
        self.mark()

    def mark(self):
        self.before = {k: fn.launches for k, fn in self.kernels.items()}

    def since(self) -> dict:
        return {k: fn.launches - self.before[k] for k, fn in self.kernels.items()}


def kernel_supports(layers, activation: str) -> bool:
    """True when the CUDA kernels take this net: 1 ≤ d ≤ 3 inputs, hidden
    widths ≤ 128, 1–7 hidden layers, scalar output, an activation with a σ‴
    rule in the kernels."""
    layers = tuple(layers)
    return (len(layers) >= 3 and len(layers) - 1 <= MAX_LAYERS
            and 1 <= layers[0] <= 3 and layers[-1] == 1
            and all(1 <= h <= MAXW for h in layers[1:-1])
            and activation in ACT_CODES)


def check_inputs(params, x, V, w, base_val, base_lap, n_runs: int | None = None):
    """Device, dtype, shape and contiguity checks for a kernel launch.

    n_runs=None: one net, bases (n,). n_runs=R: run-stacked params (leading
    axis R on every leaf) and each base shared (n,) or per run (R, n)."""
    dev = x.device
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"x must be (n, d) float32, got {tuple(x.shape)} {x.dtype}")
    n = x.shape[0]
    lead = () if n_runs is None else (n_runs,)
    for name, t in (("V", V), ("w", w), ("base_val", base_val),
                    ("base_lap", base_lap)):
        if t is None and name.startswith("base"):
            continue
        shapes = ((n,), lead + (n,)) if name.startswith("base") else ((n,),)
        if t.device != dev or t.dtype != torch.float32 or t.shape not in shapes:
            want = " or ".join(str(s) for s in dict.fromkeys(shapes))
            raise ValueError(f"{name} must be {want} float32 on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    layers = [params[0][0].shape[-2]] + [W.shape[-1] for W, _ in params]
    for li, (W, b) in enumerate(params):
        if (W.device != dev or b.device != dev or W.dtype != torch.float32
                or b.dtype != torch.float32):
            raise ValueError(f"layer {li} params must be float32 on {dev}")
        if (W.shape != lead + (layers[li], layers[li + 1])
                or b.shape != lead + (layers[li + 1],)):
            raise ValueError(f"layer {li}: W {tuple(W.shape)}, b {tuple(b.shape)} "
                             f"do not chain with the widths {layers}"
                             + (f" for {n_runs} runs" if lead else ""))
    if layers[0] != x.shape[1]:
        raise ValueError(f"net input width {layers[0]} != d = {x.shape[1]}")
    return n, layers


def pack_params(params, n_runs: int | None = None) -> torch.Tensor:
    """Flat (W0, b0, W1, b1, ...) buffer, each W row-major (in, out); with
    n_runs, run-stacked params become one such row per run, (R, n_params)."""
    lead = () if n_runs is None else (n_runs,)
    return torch.cat([t.reshape(*lead, -1) for W, b in params for t in (W, b)],
                     dim=-1)


def unpack_flat(flat: torch.Tensor, layers):
    """Inverse of pack_params for the given widths (any leading axes): a
    tuple of (W, b) views."""
    lead = flat.shape[:-1]
    out, off = [], 0
    for k, n in zip(layers[:-1], layers[1:]):
        W = flat[..., off:off + k * n].reshape(*lead, k, n)
        off += k * n
        b = flat[..., off:off + n]
        off += n
        out.append((W, b))
    return tuple(out)


def dims_array(layers):
    return (ctypes.c_int * len(layers))(*layers)


def ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def base_stride(t) -> int:
    """Elements between two runs' rows of a base array: 0 when shared."""
    return 0 if t is None or t.ndim == 1 else t.shape[-1]


def launch_geometry(device: torch.device, n: int, d: int, n_runs: int):
    """(S, G): slots per run and grid size (csrc/common.cuh). A run's tiles
    of T = 128 // (d + 2) points are split over S = min(SM count, tiles)
    slots; G ≤ SM count persistent blocks (the kernels use ~200 KB of shared
    memory, so one block fits an SM) walk the n_runs·S work items."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-n // (MAXW // (d + 2)))
    S = max(1, min(sms, tiles))
    return S, min(n_runs * S, sms)


def device_buffer(device: torch.device, numel: int, what: str) -> torch.Tensor:
    """A float32 scratch buffer, refused with a clear error when it cannot
    fit the card (torch.empty raises in turn if the free memory is short)."""
    total = torch.cuda.get_device_properties(device).total_memory
    if 4 * numel > total:
        raise RuntimeError(f"{what}: {4 * numel / 2**30:.1f} GiB does not fit "
                           f"the card's {total / 2**30:.1f} GiB; split the runs")
    return torch.empty(numel, dtype=torch.float32, device=device)


def run_scalars(device, n_runs: int, *cols) -> torch.Tensor:
    """The kernels' per-run scalars as an (R, k) device tensor, one row per
    run, built without a host round trip: a column is a number (a fill
    value), a 0-d tensor (shared by every run) or an (R,) tensor."""
    return torch.stack([
        c.to(device=device, dtype=torch.float32).expand(n_runs)
        if isinstance(c, torch.Tensor)
        else torch.full((n_runs,), float(c), dtype=torch.float32, device=device)
        for c in cols], dim=1)


def scale_rows(v: torch.Tensor, scale) -> torch.Tensor:
    """v·scale, where scale is a number, a 0-d tensor or one value per run
    ((R,) against v's (R, N) rows)."""
    if isinstance(scale, torch.Tensor) and scale.ndim:
        scale = scale[..., None]
    return v * scale
