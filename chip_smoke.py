#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpe_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from gpe_tpu_torch/csrc with nvcc, holds each kernel
against its plain PyTorch version at the shapes of the `gpe2d_ground_state`
main path (50,176 points, [2,128,128,128,1] shifted_tanh MLP), times kernel,
plain version and a nested-autograd PyTorch expression of the same function
with CUDA events, then drives the port's main path — `train_plpinn` through
the registered config with a shortened schedule — plus a short exact-mode
fit, and checks μ against the exact linear eigenvalue. Any failure exits
non-zero. Output: the card's name and power limit, one {"kernels": [...]}
line, and a last line {"ok": true, "device": {...}}.

Needs a CUDA device; it imports nothing of JAX or of the gpe_tpu package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores
# and HBM3 bandwidth. The kernels run f32 FFMA, so the f32 CUDA-core peak is
# their operations roof.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

K1_TOL = 1e-4       # relative, per sum: f32, other summation order/association
K2_TOL = 2e-4       # max |Δ| / max |g| per leaf (tests/test_pallas_grad.py's)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the device (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def matmul_flops(layers, n: int, grad: bool) -> float:
    """Multiply-add FLOPs the kernels do on these inputs (matmuls only; the
    elementwise and transcendental work is left out, so the bound is a
    lower bound). C = d+2 channel rows per point; layer 0 multiplies the
    value channel only; the last layer is a (C x K) x (K x 1) product.
    K2 adds, per hidden GEMM layer, the W̄ and the backprop GEMMs, and the
    last layer's W̄ (value and Laplacian rows) and layer 0's W̄."""
    d = layers[0]
    C = d + 2
    hidden = list(zip(layers[1:-2], layers[2:-1]))
    per_pt = 2 * d * layers[1] + sum(2 * C * k * m for k, m in hidden) \
        + 2 * C * layers[-2]
    if grad:
        per_pt += sum(4 * C * k * m for k, m in hidden) + 4 * layers[-2] \
            + 2 * (d + 1) * layers[1]
    return float(per_pt) * n


def io_bytes(layers, n: int, grad: bool) -> float:
    """Bytes each input read once and each output written once: x (n·d),
    V, w, base value and Laplacian (n each), the parameters, the 4 sums and,
    for K2, the gradient (as large as the parameters)."""
    n_params = sum(k * m + m for k, m in zip(layers[:-1], layers[1:]))
    b = 4 * (n * layers[0] + 4 * n + n_params + 4)
    return float(b + (4 * n_params if grad else 0))


def bound(layers, n: int, grad: bool):
    t_ops = matmul_flops(layers, n, grad) / PEAK_F32_FLOPS * 1e3
    t_mem = io_bytes(layers, n, grad) / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def nested_autograd_sums(params, batch, gamma, scale, activation, p, kinetic):
    """The four sums by the reference's route: the Laplacian from nested
    reverse-mode autograd (create_graph) instead of the forward-Laplacian
    recursion. The yardstick `library_ms`; the port never calls it."""
    import torch
    from gpe_tpu_torch.models.mlp import mlp_apply

    x = batch["x"].detach().requires_grad_(True)
    net = mlp_apply(params, x, activation)
    (g,) = torch.autograd.grad(net.sum(), x, create_graph=True)
    lap = sum(torch.autograd.grad(g[:, i].sum(), x, create_graph=True)[0][:, i]
              for i in range(x.shape[1]))
    u = batch["base_val"] + scale * net
    lp = batch["base_lap"] + scale * lap
    hu = -kinetic * lp + batch["V"] * u + gamma * torch.abs(u) ** (p - 1) * u
    w = batch["w"]
    return torch.stack([torch.sum(hu * hu), torch.sum(u * hu), torch.sum(u * u),
                        torch.sum(u * u * w)])


def phase_env():
    import torch
    from gpe_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    out = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s into {out}")
    for f in sorted(out.glob("*.ptxas.log")):
        for line in f.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {f.stem}: {line.strip()}")
    return smi


def main_shape(dev):
    import torch
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.models.mlp import init_mlp
    from gpe_tpu_torch.train.problem import make_batch

    cfg = EXPERIMENTS["gpe2d_ground_state"]
    spec = cfg.spec
    batch = make_batch(spec, 0, device=dev)
    params = init_mlp(spec.layers, "xavier_uniform",
                      generator=torch.Generator().manual_seed(0), device=dev)
    return cfg, spec, batch, params


def phase_k1(spec, batch, params):
    import torch
    from gpe_tpu_torch.kernels import fused_residual as k1

    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    args = (batch["x"], batch["V"], batch["w"])
    base = (batch["base_val"], batch["base_lap"])
    worst_abs, worst_rel = 0.0, 0.0
    for gamma, scale in ((0.0, 0.01), (5.0, 0.05), (100.0, 1.0)):
        got = k1.collocation_sums(params, *args, gamma, scale, *base, **kw)
        want = k1.collocation_sums_plain(params, *args, gamma, scale, *base, **kw)
        torch.cuda.synchronize()
        ab = (got - want).abs()
        rel = float((ab / want.abs()).max())
        log(f"K1 γ={gamma} s={scale}: kernel {got.tolist()} plain {want.tolist()} "
            f"max rel {rel:.2e}")
        if not torch.isfinite(got).all() or rel > K1_TOL:
            raise AssertionError(f"K1 disagrees with its plain version: rel {rel:.3e}")
        worst_abs = max(worst_abs, float(ab.max()))
        worst_rel = max(worst_rel, rel)
    gamma, scale = 5.0, 0.05
    nested = nested_autograd_sums(params, batch, gamma, scale, spec.activation,
                                  spec.p, spec.kinetic)
    plain = k1.collocation_sums_plain(params, *args, gamma, scale, *base, **kw)
    log(f"K1 nested-autograd sums vs plain: max rel "
        f"{float(((nested.detach() - plain).abs() / plain.abs()).max()):.2e}")
    ms = time_ms(lambda: k1.collocation_sums(params, *args, gamma, scale, *base, **kw), 20)
    plain_ms = time_ms(lambda: k1.collocation_sums_plain(params, *args, gamma, scale,
                                                         *base, **kw), 10)
    lib_ms = time_ms(lambda: nested_autograd_sums(params, batch, gamma, scale,
                                                  spec.activation, spec.p,
                                                  spec.kinetic), 5)
    n = batch["x"].shape[0]
    b_ms, b_by = bound(spec.layers, n, grad=False)
    log(f"K1 timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, nested autograd "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "fused_residual", "route": "cuda",
            "source": "gpe_tpu_torch/csrc/fused_residual.cu",
            "replaces": "gpe_tpu/pallas/fused_residual.py:246",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def _grad_err(got, want):
    """(max abs error, max over leaves of max|Δ| / max|want|)."""
    worst_abs, worst_norm = 0.0, 0.0
    for (gw, gb), (ww, wb) in zip(got, want):
        for a, b in ((gw, ww), (gb, wb)):
            d = float((a - b).abs().max())
            worst_abs = max(worst_abs, d)
            worst_norm = max(worst_norm, d / (float(b.abs().max()) + 1e-30))
    return worst_abs, worst_norm


def phase_k2(spec, batch, params):
    import torch
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1

    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    args = (batch["x"], batch["V"], batch["w"])
    base = (batch["base_val"], batch["base_lap"])
    n = batch["x"].shape[0]
    worst_abs = 0.0
    for gamma, scale in ((0.0, 0.01), (5.0, 0.05), (100.0, 1.0)):
        sums = k1.collocation_sums(params, *args, gamma, scale, *base, **kw)
        _, _, _, cots = k1.sums_to_loss(sums, n, spec.norm_weight)
        # exact mode: this step's cotangents; delayed mode: stale ones
        stale = k1.sums_to_loss(sums * torch.tensor([1.3, 0.9, 1.1, 0.8],
                                                    device=sums.device),
                                n, spec.norm_weight)[3]
        for mode, c in (("exact", cots), ("delayed", stale)):
            got, s_got = k2.collocation_grads(params, *args, gamma, scale, c, *base, **kw)
            want, _ = k2.collocation_grads_plain(params, *args, gamma, scale, c,
                                                 *base, **kw)
            torch.cuda.synchronize()
            ab, norm = _grad_err(got, want)
            s_rel = float(((s_got - sums).abs() / sums.abs()).max())
            log(f"K2 {mode} γ={gamma} s={scale}: grad max|Δ| {ab:.3e}, "
                f"normalised {norm:.2e}; its sums vs K1 max rel {s_rel:.2e}")
            if norm > K2_TOL or s_rel > K1_TOL or not math.isfinite(ab):
                raise AssertionError(f"K2 disagrees with its plain version "
                                     f"({mode}): {norm:.3e}, sums {s_rel:.3e}")
            worst_abs = max(worst_abs, ab)
    gamma, scale = 5.0, 0.05
    sums = k1.collocation_sums(params, *args, gamma, scale, *base, **kw)
    cots = k1.sums_to_loss(sums, n, spec.norm_weight)[3]
    leaves = [t.detach().requires_grad_(True) for pair in params for t in pair]
    pairs = tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))

    def library():
        s = nested_autograd_sums(pairs, batch, gamma, scale, spec.activation,
                                 spec.p, spec.kinetic)
        return torch.autograd.grad(torch.sum(cots * s), leaves)

    ms = time_ms(lambda: k2.collocation_grads(params, *args, gamma, scale, cots,
                                              *base, **kw), 20)
    plain_ms = time_ms(lambda: k2.collocation_grads_plain(
        params, *args, gamma, scale, cots, *base, **kw), 10)
    lib_ms = time_ms(library, 3)
    b_ms, b_by = bound(spec.layers, n, grad=True)
    log(f"K2 timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, nested autograd "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "fused_grad", "route": "cuda",
            "source": "gpe_tpu_torch/csrc/fused_grad.cu",
            "replaces": "gpe_tpu/pallas/fused_grad.py:396",
            "max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def phase_main_path(cfg, dev):
    """The port's main path at full width and point count, shortened."""
    import torch
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import params_from_numpy
    from gpe_tpu_torch.train.loop import fit
    from gpe_tpu_torch.train.plpinn import ramp_optimizer, train_plpinn
    from gpe_tpu_torch.train.problem import (make_batch, make_fused_value_and_grad,
                                             make_loss_fn)

    spec = cfg.spec
    gammas = (0.0, 5.0)
    k1.collocation_sums.launches = 0
    k2.collocation_grads.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_plpinn(spec, gamma_values=gammas, modes=cfg.modes, epochs=300,
                       tol=cfg.tol, patience=cfg.patience,
                       perturb_const=cfg.perturb_const, lr=cfg.lr, seed=cfg.seed,
                       pretrain_epochs=300, check_every=100, rebase=cfg.rebase,
                       lm_polish=cfg.lm_polish, lm_steps=3, lm_cg_iters=20,
                       device=dev, verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_residual": k1.collocation_sums.launches,
                "fused_grad": k2.collocation_grads.launches}
    mus = dict(res.mu_table[0])
    log(f"train_plpinn wall {wall:.2f} s; μ per γ {mus}; epochs "
        f"{res.epochs_history[0]}; LM-polished μ {res.polished[0]['mu']:.7f}; "
        f"launches {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if not all(math.isfinite(m) for m in mus.values()) \
            or not math.isfinite(res.polished[0]["mu"]):
        raise AssertionError(f"non-finite μ: {mus}")
    if abs(mus[0.0] - 1.0) > 1e-2:
        raise AssertionError(f"μ(γ=0) = {mus[0.0]} is not within 1e-2 of 1.0")
    if not mus[5.0] > mus[0.0]:
        raise AssertionError(f"μ(5) = {mus[5.0]} ≤ μ(0) = {mus[0.0]}")

    # per-step time of the default (relaxed) and the exact fused step
    batch = make_batch(spec, 0, device=dev)
    params = params_from_numpy(res.params_by_mode[0][0.0], device=dev)
    scale = cfg.perturb_const / res.constant_history[0]
    loss_fn = make_loss_fn(spec)
    steps = {}
    for name, relaxed in (("relaxed", None), ("exact", False)):
        vag = make_fused_value_and_grad(spec, device=dev, relaxed=relaxed)
        before = (k1.collocation_sums.launches, k2.collocation_grads.launches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = fit(loss_fn, ramp_optimizer(cfg.lr), params, batch, 0.0, scale,
                epochs=200, tol=-1.0, patience=10 ** 9, check_every=100,
                value_and_grad_fn=vag)
        end.record()
        end.synchronize()
        steps[name] = start.elapsed_time(end) / 200
        after = (k1.collocation_sums.launches, k2.collocation_grads.launches)
        log(f"fit ({name}): {steps[name]:.4f} ms/step, μ {r.mu_best:.7f}, "
            f"launches K1 {after[0] - before[0]} K2 {after[1] - before[1]}")
        if abs(r.mu_best - 1.0) > 1e-2 or after[1] - before[1] != 200:
            raise AssertionError(f"exact/relaxed fit off: μ {r.mu_best}")
        if name == "exact" and after[0] - before[0] < 200:
            raise AssertionError("the exact step did not run K1 every step")
    return launches, steps


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import gpe_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the gpe_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from gpe_tpu_torch.device import pin_full_f32
    pin_full_f32()

    phase_env()
    cfg, spec, batch, params = main_shape(dev)
    kernels = [phase_k1(spec, batch, params), phase_k2(spec, batch, params)]
    del batch, params
    launches, steps = phase_main_path(cfg, dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(json.dumps({"steps_ms": steps}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
