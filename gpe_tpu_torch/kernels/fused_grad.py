"""K2 — the fused GPE training gradient, port of `gpe_tpu/pallas/fused_grad.py`,
and its run mode (K3, the port of `n_runs = M > 1`).

The loss depends on the collocation points only through the four sums
S = (Σ(Hu)², Σu·Hu, Σu², Σu²w):  L_colloc = (S₀ − S₁²/S₂)/N + λ(S₃ − 1)²,
so ∂L/∂S is four scalars c and the parameter gradient is Σ_k c_k ∂S_k/∂θ —
linear in c. `collocation_grads` computes that gradient (and S) with the
hand-written recompute-and-reverse kernel `csrc/fused_grad.cu` on CUDA
tensors; on CPU tensors it takes `collocation_grads_plain`, autograd of
Σ c_k·S_k(θ) over the plain K1 sums — the same function, independent of the
kernel's hand-derived reverse. `collocation_grads_runs` does the same for R
run-stacked nets in one launch, with (R, 4) cotangents: its plain version is
autograd of Σ_r Σ_k c_{r,k}·S_{r,k} over the plain run-mode sums. Each
launch first runs the kernel's layout kernel, which writes every run's
hidden weights padded to 128 columns, W_l and W_lᵀ, into a scratch buffer
for the gradient kernel's cp.async copies (`padded_weights` runs it alone;
`padded_weights_plain` is its plain version).

Around it, as in the JAX package:
- `vag` (exact): K1 for S and c, then K2 with those c;
- `vag_relaxed` (delayed): K2 with the previous step's cotangents, emitting
  this step's exact S — one kernel per step. Correctors: `extrapolate`
  (cotangents from 2·S_{t−1} − S_{t−2}), `refresh_every`/`exact_until`
  (exact K1 steps), `fresh_values` (S₂, S₃ from a plain value-only forward).
The boundary term (a few hundred points) is differentiated by autograd.
`runs=True` builds the run mode (n_runs > 1 in the JAX package).

`compute_dtype=torch.bfloat16` is the port of the JAX kernel's bf16 mode
(`make_pallas_value_and_grad(compute_dtype=bf16)`), which is not K1's: the
JAX kernel casts the ACTIVATION operands of its products to bf16 and keeps
the weights f32 (bf16 × f32 promotes to an f32 product). Forward: x, the
value, Jacobian and Laplacian channels are rounded before each layer's
product with the f32 weights — the relaxed step's sums come from this
forward, so they are not K1-bf16's (which rounds the weights too); the
exact step and `init_state` take K1-bf16's sums, as JAX's pass 1 does.
Reverse: W̄ = bf16(In)ᵀ·bf16(Z̄) with f32 accumulation, and the backprop
bf16(Z̄)·Wᵀ with W f32; b̄ sums the unrounded Z̄. Autograd passes a
cotangent through `.to(bfloat16)` unrounded, so it cannot express this
reverse: the plain version (`collocation_grads_bf16_plain`) is the reverse
written out step by step, rounding where the JAX kernel casts.

The psum-aware mode (JAX's `axis_name=`): under `group=` the batch's
collocation arrays are this rank's shard. The kernels run on it; the four
sums are summed over the ranks before the cotangents (with the global
point count), the weight gradients after — in the relaxed step with the
new sums, in ONE all-reduce of both. The boundary points are replicated,
so their term needs no collective. Which corrector steps run is decided on
the host from the step count, the same on every rank, so every rank makes
the same collectives.
"""
from __future__ import annotations

import ctypes

import torch

from gpe_tpu_torch.kernels import _build
from gpe_tpu_torch.kernels._common import (ACT_CODES, MAXW, NONLIN_CODES,
                                           base_stride, check_inputs,
                                           device_buffer, dims_array,
                                           kernel_supports, launch_geometry,
                                           pack_params, ptr, run_scalars,
                                           scale_rows, unpack_flat)
from gpe_tpu_torch.kernels.fused_residual import (_bf16, _per_run, _row,
                                                  check_compute_dtype,
                                                  collocation_sums,
                                                  collocation_sums_plain,
                                                  collocation_sums_runs,
                                                  collocation_sums_runs_plain,
                                                  sums_to_loss)
from gpe_tpu_torch.models.mlp import mlp_apply, run_slice
from gpe_tpu_torch.ops.laplacian import ACTIVATION_QUADS
from gpe_tpu_torch.ops.collectives import global_count, psum, psum_tree


def _leaves(params):
    return [t for W, b in params for t in (W, b)]


def _pairs(leaves):
    return tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))


def _autograd_grads(sums_fn, params, args, cots):
    """(∇θ Σ cots·sums_fn(θ, *args), sums) by autograd."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    with torch.enable_grad():
        sums = sums_fn(_pairs(leaves), *args)
        grads = torch.autograd.grad(torch.sum(cots.detach() * sums), leaves)
    return _pairs(list(grads)), sums.detach()


def collocation_grads_plain(params, x, V, w, gamma, scale, cots, base_val=None,
                            base_lap=None, activation: str = "tanh",
                            p: float = 3.0, kinetic: float = 1.0,
                            nonlinearity: str = "abs_power"):
    """Plain PyTorch K2: (∇θ Σ_k c_k·S_k, S) by autograd over the plain sums."""
    return _autograd_grads(collocation_sums_plain, params,
                           (x, V, w, gamma, scale, base_val, base_lap,
                            activation, p, kinetic, nonlinearity), cots)


def collocation_grads_runs_plain(params, x, V, w, gamma, scale, cots,
                                 base_val=None, base_lap=None,
                                 activation: str = "tanh", p: float = 3.0,
                                 kinetic: float = 1.0,
                                 nonlinearity: str = "abs_power"):
    """Plain PyTorch K2 run mode: (run-stacked ∇θ Σ_r Σ_k c_{r,k}·S_{r,k},
    (R, 4) S) by autograd over the plain run-mode sums."""
    return _autograd_grads(collocation_sums_runs_plain, params,
                           (x, V, w, gamma, scale, base_val, base_lap,
                            activation, p, kinetic, nonlinearity), cots)


def collocation_grads_bf16_plain(params, x, V, w, gamma, scale, cots,
                                 base_val=None, base_lap=None,
                                 activation: str = "tanh", p: float = 3.0,
                                 kinetic: float = 1.0,
                                 nonlinearity: str = "abs_power"):
    """Plain PyTorch K2 in the bf16 operand mode: (grads, S), the reverse
    of `gpe_tpu/pallas/fused_grad.py`'s kernel written out, each operand
    rounded to bf16 where the JAX kernel casts it. The state of a layer is
    (N, d+2, width): the value, the d Jacobian rows, the Laplacian."""
    quad = ACTIVATION_QUADS[activation]
    N, d = x.shape
    s = torch.cat([x[:, None, :], torch.eye(d, dtype=x.dtype, device=x.device)
                   .expand(N, d, d), x.new_zeros(N, 1, d)], dim=1)
    ins, saved = [], []
    L = len(params)
    for li, (W, b) in enumerate(params):
        ins.append(s)
        zz = torch.matmul(_bf16(s), W)                      # bf16(In) · f32 W
        z, jz, lz = zz[:, 0] + b, zz[:, 1:1 + d], zz[:, 1 + d]
        if li < L - 1:
            s0, s1, s2, s3 = quad(z)
            g2 = torch.sum(jz * jz, dim=1)
            saved.append((jz, lz, s1, s2, s3, g2))
            s = torch.cat([s0[:, None], s1[:, None] * jz, (s1 * lz + s2 * g2)[:, None]],
                          dim=1)
    v, lp = z[:, 0], lz[:, 0]
    u = scale * v if base_val is None else base_val + scale * v
    lap = scale * lp if base_lap is None else base_lap + scale * lp
    au = torch.abs(u)
    if nonlinearity == "power":
        nl, dnl = gamma * u ** p, gamma * p * u ** (p - 1.0)
    else:
        nl, dnl = gamma * au ** (p - 1.0) * u, gamma * p * au ** (p - 1.0)
    hu = -kinetic * lap + V * u + nl
    sums = torch.stack([torch.sum(hu * hu), torch.sum(u * hu), torch.sum(u * u),
                        torch.sum(u * u * w)])
    c0, c1, c2, c3 = cots.unbind(-1)
    hu_bar = 2.0 * c0 * hu + c1 * u
    u_bar = c1 * hu + 2.0 * c2 * u + 2.0 * c3 * w * u + hu_bar * (V + dnl)
    zero = torch.zeros_like(u_bar)
    zb = torch.stack([scale * u_bar] + [zero] * d + [scale * (-kinetic * hu_bar)],
                     dim=1)[:, :, None]
    grads = [None] * L
    for li in range(L - 1, -1, -1):
        grads[li] = (torch.einsum("nck,nco->ko", _bf16(ins[li]), _bf16(zb)),
                     torch.sum(zb[:, 0], dim=0))
        if li == 0:
            break
        ob = torch.matmul(_bf16(zb), params[li][0].transpose(0, 1))   # bf16(Z̄)·Wᵀ
        vb, jb, lb = ob[:, 0], ob[:, 1:1 + d], ob[:, 1 + d]
        jz, lz, s1, s2, s3, g2 = saved[li - 1]
        jj = torch.sum(jz * jb, dim=1)
        zb = torch.cat([(s1 * vb + s2 * jj + (s2 * lz + s3 * g2) * lb)[:, None],
                        s1[:, None] * jb + 2.0 * (s2 * lb)[:, None] * jz,
                        (s1 * lb)[:, None]], dim=1)
    return tuple(grads), sums


def split_bf16x3(w: torch.Tensor):
    """(hi, mid, lo): f32 `w` as the three bf16 terms that K2's bf16 mode
    multiplies on the card (common.cuh split_bf16x3): hi = bf16(w), mid =
    bf16(w − hi), lo = bf16(w − hi − mid), each rounded to nearest even,
    the residuals taken in f32 (where they are exact). hi + mid + lo = w
    exactly wherever lo is a bf16 value (|w| ≳ 2^-110), so a product
    bf16(x)·w is the sum of three products that are each exact in f32."""
    w = w.float()
    hi = w.to(torch.bfloat16)
    r = w - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def collocation_grads_runs_bf16_plain(params, x, V, w, gamma, scale, cots,
                                      base_val=None, base_lap=None,
                                      activation: str = "tanh", p: float = 3.0,
                                      kinetic: float = 1.0,
                                      nonlinearity: str = "abs_power"):
    """The bf16 plain K2 of each run of run-stacked params: (run-stacked
    grads, (R, 4) S)."""
    R = params[0][0].shape[0]
    gs, ss = _per_run(gamma, R), _per_run(scale, R)
    outs = [collocation_grads_bf16_plain(
        run_slice(params, r), x, V, w, gs[r], ss[r], cots[r], _row(base_val, r),
        _row(base_lap, r), activation, p, kinetic, nonlinearity) for r in range(R)]
    grads = tuple((torch.stack([o[0][li][0] for o in outs]),
                   torch.stack([o[0][li][1] for o in outs]))
                  for li in range(len(params)))
    return grads, torch.stack([o[1] for o in outs])


def _bind(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gpe_k2_grads_runs.argtypes = [P, P, P, P, I, P, I, P, ctypes.POINTER(I),
                                      I, I, I, I, F, F, P, I, I, P, P, P, I, P, P, I]
    lib.gpe_k2_grads_runs.restype = I
    lib.gpe_k2_pad_weights.argtypes = [P, ctypes.POINTER(I), I, I, P, P]
    lib.gpe_k2_pad_weights.restype = I


def padded_floats(layers) -> int:
    """Floats per run of K2's padded-weight buffer: each hidden GEMM layer
    W_l (l = 1..L-2) as (K, 128) and as W_lᵀ (N, 128)."""
    return sum((k + m) * MAXW for k, m in zip(layers[1:-2], layers[2:-1]))


def padded_weights_plain(params, n_runs: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of csrc/fused_grad.cu's layout kernel: per run,
    each hidden GEMM layer W_l (l = 1..L-2) zero-padded to (K, 128) columns,
    then W_lᵀ zero-padded to (N, 128), laid end to end: (padded_floats,) for
    one net, (R, padded_floats) for run-stacked params."""
    lead = () if n_runs is None else (n_runs,)
    parts = [torch.nn.functional.pad(A, (0, MAXW - A.shape[-1])).reshape(*lead, -1)
             for W, _ in params[1:-1] for A in (W, W.transpose(-1, -2))]
    return torch.cat(parts, dim=-1) if parts else params[0][0].new_zeros(*lead, 0)


def padded_weights(params, n_runs: int | None = None) -> torch.Tensor:
    """K2's layout kernel alone (the launch `collocation_grads` makes first)
    on CUDA tensors, `padded_weights_plain` on CPU tensors."""
    dev = params[0][0].device
    if dev.type == "cpu":
        return padded_weights_plain(params, n_runs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    layers = [params[0][0].shape[-2]] + [W.shape[-1] for W, _ in params]
    lib = _build.library("fused_grad", _bind)
    R = n_runs or 1
    out = torch.empty((R, padded_floats(layers)), dtype=torch.float32, device=dev)
    rc = lib.gpe_k2_pad_weights(ptr(pack_params(params, n_runs)), dims_array(layers),
                                len(layers) - 1, R, ptr(out),
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "gpe_k2_pad_weights")
    return out if n_runs else out[0]


def _launch(params, x, V, w, scal, base_val, base_lap, activation, p, kinetic,
            nonlinearity, n_runs, bf16=False):
    """One launch of csrc/fused_grad.cu for n_runs run-stacked nets (None:
    one net; bf16: the bf16 operand mode); returns (R, n_params + 4): each
    run's flat gradient, then its 4 sums, and the widths."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, layers = check_inputs(params, x, V, w, base_val, base_lap, n_runs)
    if not kernel_supports(layers, activation) or nonlinearity not in NONLIN_CODES:
        raise ValueError(f"K2 does not take layers={layers}, "
                         f"activation={activation!r}, nonlinearity={nonlinearity!r}")
    lib = _build.library("fused_grad", _bind)
    dev = x.device
    R = n_runs or 1
    prm = pack_params(params, n_runs)
    n_params = prm.shape[-1]
    S, G = launch_geometry(dev, n, layers[0], R)
    wpad = device_buffer(dev, R * padded_floats(layers), "K2 padded weights")
    scratch = device_buffer(dev, G * (len(layers) - 2) * 128 * 128,
                            "K2 forward-state scratch")
    partial = device_buffer(dev, R * S * (n_params + 4), "K2 partial gradients")
    out = torch.empty((R, n_params + 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gpe_k2_grads_runs(
        ptr(x), ptr(V), ptr(w), ptr(base_val), base_stride(base_val),
        ptr(base_lap), base_stride(base_lap), ptr(prm), dims_array(layers),
        len(layers) - 1, n, ACT_CODES[activation], NONLIN_CODES[nonlinearity],
        float(p), float(kinetic), ptr(scal), R, S, ptr(wpad), ptr(scratch),
        ptr(partial), G, ptr(out), stream, int(bf16))
    _build.check(lib, rc, "gpe_k2_grads_runs")
    return out, layers


def collocation_grads(params, x, V, w, gamma, scale, cots, base_val=None,
                      base_lap=None, activation: str = "tanh", p: float = 3.0,
                      kinetic: float = 1.0, nonlinearity: str = "abs_power",
                      compute_dtype=torch.float32):
    """(grads as ((W̄, b̄), ...), S) — the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. cots: the (4,) cotangents c = ∂L/∂S.
    Launches count in `.launches` (f32) and `.bf16_launches`."""
    bf16 = check_compute_dtype(compute_dtype)
    if x.device.type == "cpu":
        plain = collocation_grads_bf16_plain if bf16 else collocation_grads_plain
        return plain(params, x, V, w, gamma, scale, cots, base_val, base_lap,
                     activation, p, kinetic, nonlinearity)
    scal = run_scalars(x.device, 1, gamma, scale, *cots.unbind(-1))
    out, layers = _launch(params, x, V, w, scal, base_val, base_lap, activation,
                          p, kinetic, nonlinearity, None, bf16)
    if bf16:
        collocation_grads.bf16_launches += 1
    else:
        collocation_grads.launches += 1
    return unpack_flat(out[0, :-4], layers), out[0, -4:]


collocation_grads.launches = 0
collocation_grads.bf16_launches = 0


def collocation_grads_runs(params, x, V, w, gamma, scale, cots, base_val=None,
                           base_lap=None, activation: str = "tanh",
                           p: float = 3.0, kinetic: float = 1.0,
                           nonlinearity: str = "abs_power",
                           compute_dtype=torch.float32):
    """(run-stacked grads, (R, 4) S) of R run-stacked nets in one launch —
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    cots: (R, 4) per-run cotangents; γ, scale and bases as in
    `collocation_sums_runs`. Launches count in `.launches` (f32) and
    `.bf16_launches`."""
    bf16 = check_compute_dtype(compute_dtype)
    if x.device.type == "cpu":
        plain = (collocation_grads_runs_bf16_plain if bf16
                 else collocation_grads_runs_plain)
        return plain(params, x, V, w, gamma, scale, cots, base_val, base_lap,
                     activation, p, kinetic, nonlinearity)
    R = params[0][0].shape[0]
    scal = run_scalars(x.device, R, gamma, scale, *cots.unbind(-1))
    out, layers = _launch(params, x, V, w, scal, base_val, base_lap, activation,
                          p, kinetic, nonlinearity, R, bf16)
    if bf16:
        collocation_grads_runs.bf16_launches += 1
    else:
        collocation_grads_runs.launches += 1
    return unpack_flat(out[:, :-4], layers), out[:, -4:]


collocation_grads_runs.launches = 0
collocation_grads_runs.bf16_launches = 0


def make_value_and_grad(layers, activation: str = "tanh", p: float = 3.0,
                        kinetic: float = 1.0, nonlinearity: str = "abs_power",
                        bc_weight: float = 10.0, norm_weight: float = 20.0,
                        delayed: bool = False, refresh_every: int = 0,
                        extrapolate: bool = False, exact_until: int = 0,
                        fresh_values: bool = False, runs: bool = False,
                        compute_dtype=torch.float32):
    """vag(params, batch, gamma, scale) -> ((total, aux), grads), the
    contract of autograd over make_loss_fn for a plain or perturbation
    ansatz; with delayed=True the stateful relaxed form
    vag(params, batch, gamma, scale, state) -> ((total, aux), grads, state)
    with `vag.init_state(params, batch, gamma, scale)`.

    The relaxed state is (S_{t−1}, S_{t−2}, step): two (4,) device tensors
    and the host step count (which only decides whether a step runs K1).

    runs=True is the run mode (the JAX package's n_runs = M > 1): params are
    run-stacked, γ and scale numbers or (R,) tensors, the batch's base arrays
    shared ((n,), (B,)) or per run ((R, n), (R, B)); total and every aux entry
    are (R,), the gradient is run-stacked, the boundary objective is
    Σ_r mean_r(bv²) with the per-run means in aux, and the relaxed state
    holds (R, 4) sums. Each run's results are those of its own vag.

    A single-run vag carries its run-mode twin, built with the same relaxed
    settings, as `vag.run_axis`: an ensemble trainer (`loop.fit_ensemble`)
    steps R runs of it in one launch where the JAX package vmaps the
    single-run vag.

    Every form takes `group=` (a process group; JAX's `axis_name`) and is
    marked `psum_aware`: the psum-aware mode of the module docstring, which
    `fit(mesh=)` runs through `parallel.mesh.make_parallel_vag`; the
    relaxed state then holds the global sums, the same on every rank.

    compute_dtype=torch.bfloat16 is the bf16 operand mode of the module
    docstring, in every form: K1-bf16 sums (exact step, `init_state`, the
    correctors' refreshes) and K2-bf16 gradients."""
    if layers[-1] != 1:
        raise ValueError("scalar-output nets only")
    check_compute_dtype(compute_dtype)
    kw = dict(activation=activation, p=p, kinetic=kinetic,
              nonlinearity=nonlinearity, compute_dtype=compute_dtype)
    sums_fn = collocation_sums_runs if runs else collocation_sums
    grads_fn = collocation_grads_runs if runs else collocation_grads

    def _u(params, x, scale, base):
        """base + scale·net(x): (N,), or (R, N) in the run mode."""
        u = scale_rows(mlp_apply(params, x, activation), scale)
        return u if base is None else base + u

    def boundary_vg(params, bx, scale, base_bval):
        """(mean(bv²) per run, the gradient of their sum) by autograd."""
        leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
        with torch.enable_grad():
            bv = _u(_pairs(leaves), bx, scale, base_bval)
            means = torch.mean(bv * bv, dim=-1)
            grads = torch.autograd.grad(torch.sum(means), leaves)
        return means.detach(), grads

    def _merge(cgrads, bgrads):
        leaves = [c + bc_weight * b for c, b in zip(_leaves(cgrads), bgrads)]
        return _pairs(leaves)

    def _finish(params, batch, scale, sums, cgrads, n):
        mu, pde, norm, _ = sums_to_loss(sums, n, norm_weight)
        bmean, bgrads = boundary_vg(params, batch["bx"], scale,
                                    batch.get("base_bval"))
        total = pde + bc_weight * bmean + norm_weight * norm
        aux = {"pde": pde, "boundary": bmean, "norm": norm, "mu": mu,
               "total": total}
        return (total, aux), _merge(cgrads, bgrads)

    def _sums(params, batch, gamma, scale):
        return sums_fn(params, batch["x"], batch["V"], batch["w"], gamma, scale,
                       batch.get("base_val"), batch.get("base_lap"), **kw)

    def _grads(params, batch, gamma, scale, cots):
        return grads_fn(params, batch["x"], batch["V"], batch["w"], gamma, scale,
                        cots, batch.get("base_val"), batch.get("base_lap"), **kw)

    def vag(params, batch, gamma, scale, group=None):
        n = global_count(batch["x"].shape[0], group)
        sums = psum(_sums(params, batch, gamma, scale), group)
        _, _, _, cots = sums_to_loss(sums, n, norm_weight)
        cgrads, _ = _grads(params, batch, gamma, scale, cots)
        return _finish(params, batch, scale, sums, psum_tree(cgrads, group), n)

    def with_twin(fn):
        fn.psum_aware = True
        if not runs:
            fn.run_axis = make_value_and_grad(
                layers, activation, p, kinetic, nonlinearity, bc_weight,
                norm_weight, delayed, refresh_every, extrapolate, exact_until,
                fresh_values, runs=True, compute_dtype=compute_dtype)
        return fn

    if not delayed:
        return with_twin(vag)

    def _value_sums(params, x, w, scale, base_val):
        """Exact (S₂, S₃) = (Σu², Σu²w) from a value-only plain forward."""
        u = _u(params, x, scale, base_val)
        return torch.stack([torch.sum(u * u, dim=-1), torch.sum(u * u * w, dim=-1)],
                           dim=-1)

    def init_state(params, batch, gamma, scale, group=None):
        """Exact sums of the initial params (one K1 launch per fit); both
        histories start there, so step 0's cotangents are exact."""
        s = psum(_sums(params, batch, gamma, scale), group)
        return (s, s, 0)

    def vag_relaxed(params, batch, gamma, scale, state, group=None):
        n = global_count(batch["x"].shape[0], group)
        sums_prev, sums_prev2, step = state
        sums_cot = 2.0 * sums_prev - sums_prev2 if extrapolate else sums_prev
        do = 0 < step < exact_until or (
            refresh_every and step > 0 and step % refresh_every == 0)
        if do:
            sums_cot = psum(_sums(params, batch, gamma, scale), group)
        if fresh_values:
            sums_cot = torch.cat([sums_cot[..., :2], psum(_value_sums(
                params, batch["x"], batch["w"], scale, batch.get("base_val")),
                group)], dim=-1)
        _, _, _, cots = sums_to_loss(sums_cot, n, norm_weight)
        cgrads, sums_new = psum_tree(_grads(params, batch, gamma, scale, cots), group)
        value, grads = _finish(params, batch, scale, sums_new, cgrads, n)
        return value, grads, (sums_new, sums_prev, step + 1)

    vag_relaxed.stateful = True
    vag_relaxed.init_state = init_state
    return with_twin(vag_relaxed)
