"""K2 — the fused GPE training gradient, port of `gpe_tpu/pallas/fused_grad.py`.

The loss depends on the collocation points only through the four sums
S = (Σ(Hu)², Σu·Hu, Σu², Σu²w):  L_colloc = (S₀ − S₁²/S₂)/N + λ(S₃ − 1)²,
so ∂L/∂S is four scalars c and the parameter gradient is Σ_k c_k ∂S_k/∂θ —
linear in c. `collocation_grads` computes that gradient (and S) with the
hand-written recompute-and-reverse kernel `csrc/fused_grad.cu` on CUDA
tensors; on CPU tensors it takes `collocation_grads_plain`, autograd of
Σ c_k·S_k(θ) over the plain K1 sums — the same function, independent of the
kernel's hand-derived reverse.

Around it, as in the JAX package:
- `vag` (exact): K1 for S and c, then K2 with those c;
- `vag_relaxed` (delayed): K2 with the previous step's cotangents, emitting
  this step's exact S — one kernel per step. Correctors: `extrapolate`
  (cotangents from 2·S_{t−1} − S_{t−2}), `refresh_every`/`exact_until`
  (exact K1 steps), `fresh_values` (S₂, S₃ from a plain value-only forward).
The boundary term (a few hundred points) is differentiated by autograd.
Only one run per launch (the JAX package's n_runs = 1).
"""
from __future__ import annotations

import ctypes

import torch

from gpe_tpu_torch.kernels import _build
from gpe_tpu_torch.kernels._common import (ACT_CODES, NONLIN_CODES, check_inputs,
                                           dims_array, kernel_supports, n_blocks,
                                           pack_params, ptr, scalars, unpack_flat)
from gpe_tpu_torch.kernels.fused_residual import (collocation_sums,
                                                  collocation_sums_plain,
                                                  sums_to_loss)
from gpe_tpu_torch.models.mlp import mlp_apply


def _leaves(params):
    return [t for W, b in params for t in (W, b)]


def _pairs(leaves):
    return tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))


def collocation_grads_plain(params, x, V, w, gamma, scale, cots, base_val=None,
                            base_lap=None, activation: str = "tanh",
                            p: float = 3.0, kinetic: float = 1.0,
                            nonlinearity: str = "abs_power"):
    """Plain PyTorch K2: (∇θ Σ_k c_k·S_k, S) by autograd over the plain sums."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    with torch.enable_grad():
        sums = collocation_sums_plain(_pairs(leaves), x, V, w, gamma, scale,
                                      base_val, base_lap, activation, p,
                                      kinetic, nonlinearity)
        grads = torch.autograd.grad(torch.sum(cots.detach() * sums), leaves)
    return _pairs(list(grads)), sums.detach()


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gpe_k2_grads.argtypes = [P, P, P, P, P, P, ctypes.POINTER(I), I, I, I,
                                 I, F, F, P, P, P, I, P, P]
    lib.gpe_k2_grads.restype = I


def collocation_grads(params, x, V, w, gamma, scale, cots, base_val=None,
                      base_lap=None, activation: str = "tanh", p: float = 3.0,
                      kinetic: float = 1.0, nonlinearity: str = "abs_power"):
    """(grads as ((W̄, b̄), ...), S) — the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. cots: the (4,) cotangents c = ∂L/∂S."""
    if x.device.type == "cpu":
        return collocation_grads_plain(params, x, V, w, gamma, scale, cots,
                                       base_val, base_lap, activation, p,
                                       kinetic, nonlinearity)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, layers = check_inputs(params, x, V, w, base_val, base_lap)
    if not kernel_supports(layers, activation) or nonlinearity not in NONLIN_CODES:
        raise ValueError(f"K2 does not take layers={layers}, "
                         f"activation={activation!r}, nonlinearity={nonlinearity!r}")
    lib = _build.library("fused_grad", _bind)
    dev = x.device
    prm = pack_params(params)
    n_params = prm.numel()
    scal = scalars(dev, gamma, scale, *cots.unbind())
    P = n_blocks(dev)
    scratch = torch.empty(P * (len(layers) - 2) * 128 * 128,
                          dtype=torch.float32, device=dev)
    partial = torch.empty(P * (n_params + 4), dtype=torch.float32, device=dev)
    out = torch.empty(n_params + 4, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gpe_k2_grads(
        ptr(x), ptr(V), ptr(w), ptr(base_val), ptr(base_lap), ptr(prm),
        dims_array(layers), len(layers) - 1, n, ACT_CODES[activation],
        NONLIN_CODES[nonlinearity], float(p), float(kinetic), ptr(scal),
        ptr(scratch), ptr(partial), P, ptr(out), stream)
    _build.check(lib, rc, "gpe_k2_grads")
    collocation_grads.launches += 1
    return unpack_flat(out[:n_params], layers), out[n_params:]


collocation_grads.launches = 0


def make_value_and_grad(layers, activation: str = "tanh", p: float = 3.0,
                        kinetic: float = 1.0, nonlinearity: str = "abs_power",
                        bc_weight: float = 10.0, norm_weight: float = 20.0,
                        delayed: bool = False, refresh_every: int = 0,
                        extrapolate: bool = False, exact_until: int = 0,
                        fresh_values: bool = False):
    """vag(params, batch, gamma, scale) -> ((total, aux), grads), the
    contract of autograd over make_loss_fn for a plain or perturbation
    ansatz; with delayed=True the stateful relaxed form
    vag(params, batch, gamma, scale, state) -> ((total, aux), grads, state)
    with `vag.init_state(params, batch, gamma, scale)`.

    The relaxed state is (S_{t−1}, S_{t−2}, step): two (4,) device tensors
    and the host step count (which only decides whether a step runs K1)."""
    if layers[-1] != 1:
        raise ValueError("scalar-output nets only")
    kw = dict(activation=activation, p=p, kinetic=kinetic,
              nonlinearity=nonlinearity)

    def boundary_vg(params, bx, scale, base_bval):
        """(mean((base_bval + scale·net(bx))²), its gradient) by autograd."""
        leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
        with torch.enable_grad():
            bv = base_bval + mlp_apply(_pairs(leaves), bx, activation) * scale
            m = torch.mean(bv * bv)
            grads = torch.autograd.grad(m, leaves)
        return m.detach(), grads

    def _merge(cgrads, bgrads):
        leaves = [c + bc_weight * b for c, b in zip(_leaves(cgrads), bgrads)]
        return _pairs(leaves)

    def _finish(params, batch, scale, sums, cgrads):
        mu, pde, norm, _ = sums_to_loss(sums, batch["x"].shape[0], norm_weight)
        bmean, bgrads = boundary_vg(params, batch["bx"], scale,
                                    batch.get("base_bval", 0.0))
        total = pde + bc_weight * bmean + norm_weight * norm
        aux = {"pde": pde, "boundary": bmean, "norm": norm, "mu": mu,
               "total": total}
        return (total, aux), _merge(cgrads, bgrads)

    def _sums(params, batch, gamma, scale):
        return collocation_sums(params, batch["x"], batch["V"], batch["w"],
                                gamma, scale, batch.get("base_val"),
                                batch.get("base_lap"), **kw)

    def _grads(params, batch, gamma, scale, cots):
        return collocation_grads(params, batch["x"], batch["V"], batch["w"],
                                 gamma, scale, cots, batch.get("base_val"),
                                 batch.get("base_lap"), **kw)

    def vag(params, batch, gamma, scale):
        sums = _sums(params, batch, gamma, scale)
        _, _, _, cots = sums_to_loss(sums, batch["x"].shape[0], norm_weight)
        cgrads, _ = _grads(params, batch, gamma, scale, cots)
        return _finish(params, batch, scale, sums, cgrads)

    if not delayed:
        return vag

    def _value_sums(params, x, w, scale, base_val):
        """Exact (S₂, S₃) = (Σu², Σu²w) from a value-only plain forward."""
        u = scale * mlp_apply(params, x, activation)
        if base_val is not None:
            u = base_val + u
        return torch.stack([torch.sum(u * u), torch.sum(u * u * w)])

    def init_state(params, batch, gamma, scale):
        """Exact sums of the initial params (one K1 launch per fit); both
        histories start there, so step 0's cotangents are exact."""
        s = _sums(params, batch, gamma, scale)
        return (s, s, 0)

    def vag_relaxed(params, batch, gamma, scale, state):
        sums_prev, sums_prev2, step = state
        sums_cot = 2.0 * sums_prev - sums_prev2 if extrapolate else sums_prev
        do = 0 < step < exact_until or (
            refresh_every and step > 0 and step % refresh_every == 0)
        if do:
            sums_cot = _sums(params, batch, gamma, scale)
        if fresh_values:
            sums_cot = torch.cat([sums_cot[:2], _value_sums(
                params, batch["x"], batch["w"], scale, batch.get("base_val"))])
        _, _, _, cots = sums_to_loss(sums_cot, batch["x"].shape[0], norm_weight)
        cgrads, sums_new = _grads(params, batch, gamma, scale, cots)
        value, grads = _finish(params, batch, scale, sums_new, cgrads)
        return value, grads, (sums_new, sums_prev, step + 1)

    vag_relaxed.stateful = True
    vag_relaxed.init_state = init_state
    return vag_relaxed
