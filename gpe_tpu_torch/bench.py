"""The port's throughput benchmark, port of the repo's `bench.py` measurement
(`bench_jax`) on the CUDA card:

    python -m gpe_tpu_torch.bench

One configuration, as in `bench.py`: 224² = 50,176 collocation points, the
[2,100,100,100,1] shifted_tanh MLP from `init_mlp` with seed 0, harmonic
trap a = 0.5, kinetic 0.5, abs_power p = 3, vanilla ansatz, γ = 100,
s = 0.01. Each quantity is timed on the card with CUDA events, every
iteration doing the whole evaluation or step:

- the plain f32 loss eval (`make_loss_fn`) and the plain eval with
  spec.dtype = bfloat16;
- the autograd training step (clip 1.0 + Adam 1e-3), and the fused exact
  and relaxed steps (K2, with K1 in the exact step);
- the fused eval on K1 and on K4, each in f32 and with bf16 GEMM operands;
- the GEMM-engine propagator `evolve_gemm` on a 256² periodic grid, γ = 100,
  per step: a 400-step call less a 200-step call (doubled until the
  difference exceeds the spread of the repeats), so the host build of the
  propagators, the copies and the final read of the observables cancel;
- the nested-autograd eval of the same loss (the reference's route), the
  yardstick of `vs_baseline`.

It prints one JSON line. Unlike `bench.py` it has no scan regression (a
time ≤ 0 is an error, never clamped), no retries or stale captures, and no
"skipped" candidates: a kernel that fails to launch or misses its parity
limit (rel < 1e-3 against the plain f32 loss, < 0.1 for bf16 operands)
fails the run. It reads and writes no cache file. The best f32 eval's rate
is read against the card's f32 peak outside the tensor cores, the best
bf16-operand kernel's against its dense bf16 tensor-core peak.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device

N_SIDE = 224
LAYERS = (2, 100, 100, 100, 1)
GAMMA, SCALE = 100.0, 0.01
LR = 1e-3
ITERS = 20
DYN_N, DYN_STEPS = 256, 200
K4_TILE = 1792                  # bench.py's first K4 tile
# Published dense peaks of the H100 SXM (NVIDIA data sheet), by GEMM operand
# type: f32 outside the tensor cores; tf32x3, the dense TF32 tensor-core rate
# over the three TF32 products of one f32-parity product (3xTF32), the least
# time in which the card gives f32-parity products and so the roof of the f32
# kernels; bf16 on the tensor cores with f32 accumulation, the roof of any
# kernel whose GEMM operands are bf16, however it is written.
PEAK_FLOPS = {"f32": 67e12, "tf32x3": 495e12 / 3, "bf16": 989e12}
LOSS_TOL_F32, LOSS_TOL_BF16 = 1e-3, 0.1


class ParityError(AssertionError):
    """A measured path disagrees with the plain f32 loss beyond its limit."""


def matmul_flops(layers, n: int, grad: bool) -> float:
    """Multiply-add FLOPs the fused kernels do on these inputs (matmuls only;
    the elementwise and transcendental work is left out, so a bound from it
    is a lower bound). C = d+2 channel rows per point; layer 0 multiplies the
    value channel only; the last layer is a (C x K) x (K x 1) product. The
    gradient (K2) adds, per hidden GEMM layer, the W̄ and the backprop
    GEMMs, and the last layer's W̄ (value and Laplacian rows) and layer 0's
    W̄."""
    d = layers[0]
    C = d + 2
    hidden = list(zip(layers[1:-2], layers[2:-1]))
    per_pt = 2 * d * layers[1] + sum(2 * C * k * m for k, m in hidden) \
        + 2 * C * layers[-2]
    if grad:
        per_pt += sum(4 * C * k * m for k, m in hidden) + 4 * layers[-2] \
            + 2 * (d + 1) * layers[1]
    return float(per_pt) * n


def nested_autograd_sums(params, batch, gamma, scale, activation, p, kinetic,
                         nonlinearity):
    """The four loss sums by the reference's route: the Laplacian from nested
    reverse-mode autograd (create_graph) instead of the forward-Laplacian
    recursion. A yardstick only; no path of the port calls it."""
    from gpe_tpu_torch.models.mlp import mlp_apply
    from gpe_tpu_torch.ops.rayleigh import nonlinear_term

    with torch.enable_grad():
        x = batch["x"].detach().requires_grad_(True)
        net = mlp_apply(params, x, activation)
        (g,) = torch.autograd.grad(net.sum(), x, create_graph=True)
        lap = sum(torch.autograd.grad(g[:, i].sum(), x, create_graph=True)[0][:, i]
                  for i in range(x.shape[1]))
    u = scale * net
    lp = scale * lap
    if "base_val" in batch:
        u = batch["base_val"] + u
        lp = batch["base_lap"] + lp
    hu = -kinetic * lp + batch["V"] * u + nonlinear_term(u, gamma, p, nonlinearity)
    w = batch["w"]
    return torch.stack([torch.sum(hu * hu), torch.sum(u * hu), torch.sum(u * u),
                        torch.sum(u * u * w)])


def bench_spec(dtype=torch.float32, n_side: int = N_SIDE, layers=LAYERS):
    from gpe_tpu_torch.train.problem import GPESpec
    return GPESpec(dim=2, n_points=n_side, layers=tuple(layers),
                   potential="harmonic", potential_kwargs=(("a", 0.5),),
                   kinetic=0.5, basis="hermite", lb=-6.0, ub=6.0,
                   nonlinearity="abs_power", use_perturbation=False, dtype=dtype)


def bench_tile(n: int) -> int:
    """The K4 tile for n points: bench.py's 1792 where it divides n (it
    divides the benchmark's 50,176), else the largest divisor of both."""
    return math.gcd(n, K4_TILE)


def dynamics_grid(n: int = DYN_N):
    """(ψ0, V, dx, lb) of the propagator benchmark: an n² periodic grid on
    [-12, 12)², the trap ½|x|² in f32 and a normalised complex64 Gaussian
    displaced by 0.5 along x, so that it moves."""
    x = np.linspace(-12.0, 12.0, n, endpoint=False)
    dx = float(x[1] - x[0])
    X, Y = np.meshgrid(x, x, indexing="ij")
    V = (0.5 * (X ** 2 + Y ** 2)).astype(np.float32)
    psi = np.exp(-0.5 * ((X - 0.5) ** 2 + Y ** 2)).astype(np.complex64)
    psi /= np.sqrt((np.abs(psi) ** 2).sum() * dx * dx)
    return psi, V, dx, float(x[0])


def card_info(device: torch.device):
    """(name, power limit) of the device: nvidia-smi's name and power.limit
    on the card, ("cpu", None) on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(device.index or 0)],
                         capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (s.strip() for s in out.split(",", 1))
    return name, limit


def time_ms(fn, iters: int, device: torch.device, warmup: int = 2) -> float:
    """Mean milliseconds per call: CUDA events on the card; on the CPU (tests
    only) the host clock."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, device: torch.device, warmup: int = 2) -> float:
    """Mean device milliseconds per call of `fn`: its launches captured once
    in a CUDA graph, whose replays are timed with CUDA events, so the host
    work of the call (argument checks, packing, ctypes) is left out. Needs a
    CUDA device; `fn` may not synchronise."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    return time_ms(graph.replay, iters, device)


def per_sec(count: float, ms: float, what: str) -> float:
    """count / (ms/1000); a time that is not positive and finite is an
    error, never clamped."""
    if not (math.isfinite(ms) and ms > 0.0):
        raise ValueError(f"{what}: measured {ms} ms per call does not resolve")
    return count / (ms * 1e-3)


def check_parity(what: str, got, ref: float, tol: float) -> float:
    """Relative error of a loss against the plain f32 loss; raises
    ParityError beyond tol."""
    got = float(got)
    rel = abs(got - ref) / max(abs(ref), 1e-12)
    if not (math.isfinite(got) and rel < tol):
        raise ParityError(f"{what}: loss {got} against the plain f32 {ref}, "
                          f"rel {rel:.3e} (limit {tol})")
    return rel


def _train_ms(vag, params, batch, iters, device, stateful=False):
    """ms per training step (vag, then clip 1.0 + Adam 1e-3 and the update)
    and the loss of the first step."""
    from gpe_tpu_torch.train.optimizers import ClipAdam, _leaves, _pairs

    opt = ClipAdam(clip=1.0, count_scale=lambda _: -LR)
    st = {"p": params, "opt": opt.init(params)}
    if stateful:
        st["vs"] = vag.init_state(params, batch, GAMMA, SCALE)

    def step():
        if stateful:
            (total, _), grads, st["vs"] = vag(st["p"], batch, GAMMA, SCALE, st["vs"])
        else:
            (total, _), grads = vag(st["p"], batch, GAMMA, SCALE)
        upd, st["opt"] = opt.update(grads, st["opt"], st["p"], value=total)
        st["p"] = _pairs(torch._foreach_add(_leaves(st["p"]), _leaves(upd)))
        return total

    first = float(step())
    st["p"], st["opt"] = params, opt.init(params)
    if stateful:
        st["vs"] = vag.init_state(params, batch, GAMMA, SCALE)
    return time_ms(step, iters, device), first


def propagator_ms(engine, device, n: int = DYN_N, steps: int = DYN_STEPS) -> float:
    """ms per step of `engine` (split_step.evolve or gemm_step.evolve_gemm)
    on dynamics_grid(n), γ = 100, dt = 1e-3, observed at the ends: the best
    of three 2·S-step calls less the best of three S-step calls, over S.
    Each call builds its propagators on the host, copies them over and reads
    the observables back; the difference cancels that. The S- and 2·S-step
    calls alternate, and the difference counts only once it exceeds the
    spread (max − min) of either set of repeats: until then S doubles, from
    `steps`, at most five times; past that the time does not resolve and
    ValueError is raised."""
    psi, V, dx, lb = dynamics_grid(n)
    run = lambda k: engine(psi, V, dx, 1e-3, k, GAMMA, bc="periodic", lb=lb,
                           record_every=k, device=device)
    _, obs = run(steps)
    if not np.all(np.isfinite(obs["norm"])) or abs(obs["norm"][-1] - 1.0) > 1e-2:
        raise ParityError(f"{engine.__name__} lost the norm: {obs['norm']}")
    S = steps
    for _ in range(6):
        t1, t2 = [], []
        for _ in range(3):
            t1.append(time_ms(lambda: run(S), 1, device, warmup=0))
            t2.append(time_ms(lambda: run(2 * S), 1, device, warmup=0))
        diff = min(t2) - min(t1)
        spread = max(max(t1) - min(t1), max(t2) - min(t2))
        if diff > spread:
            return diff / S
        S *= 2
    raise ValueError(f"{engine.__name__}: the time does not resolve: the "
                     f"{S // 2}-step difference {diff} ms against the repeats' "
                     f"spread {spread} ms")


def measure(device=None, n_side: int = N_SIDE, layers=LAYERS, iters: int = ITERS,
            dyn_n: int = DYN_N, dyn_steps: int = DYN_STEPS) -> dict:
    """Run every measurement once and return the JSON record (see the module
    docstring). device=None is the CUDA card; the CPU only on request."""
    from gpe_tpu_torch.dynamics import evolve_gemm
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.kernels import rowcat_eval as k4
    from gpe_tpu_torch.kernels.fused_grad import make_value_and_grad
    from gpe_tpu_torch.models.mlp import init_mlp
    from gpe_tpu_torch.train.loop import value_and_grad
    from gpe_tpu_torch.train.problem import make_batch, make_loss_fn

    dev = resolve_device(device)
    spec = bench_spec(n_side=n_side, layers=layers)
    batch = make_batch(spec, 0, device=dev)
    params = init_mlp(spec.layers, "xavier_uniform",
                      generator=torch.Generator().manual_seed(0), device=dev)
    n = batch["x"].shape[0]
    phys = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
                nonlinearity=spec.nonlinearity)
    weights = dict(bc_weight=spec.bc_weight, norm_weight=spec.norm_weight)
    loss_fn = make_loss_fn(spec)
    tile = bench_tile(n)
    ev = lambda f, p=params, b=batch: (lambda: f(p, b, GAMMA, SCALE)[0])
    ms, rel = {}, {}

    with torch.no_grad():
        ref = float(loss_fn(params, batch, GAMMA, SCALE)[0])
        ms["xla_eval"] = time_ms(ev(loss_fn), iters, dev)
        evals = {
            "pallas": k1.make_loss_eval(spec.layers, **phys, **weights),
            "pallas_bf16": k1.make_loss_eval(spec.layers, **phys, **weights,
                                             compute_dtype=torch.bfloat16),
            "rowcat": k4.make_rowcat_loss_eval(spec.layers, **phys, **weights,
                                               tile=tile),
            "rowcat_bf16": k4.make_rowcat_loss_eval(
                spec.layers, **phys, **weights, tile=tile,
                compute_dtype=torch.bfloat16)}
        for name, fn in evals.items():
            tol = LOSS_TOL_BF16 if name.endswith("bf16") else LOSS_TOL_F32
            rel[name] = check_parity(name, fn(params, batch, GAMMA, SCALE)[0],
                                     ref, tol)
            ms[f"{name}_eval"] = time_ms(ev(fn), iters, dev)
        spec16 = bench_spec(torch.bfloat16, n_side, layers)
        batch16 = make_batch(spec16, 0, device=dev)
        params16 = tuple((W.to(torch.bfloat16), b.to(torch.bfloat16))
                         for W, b in params)
        loss16 = make_loss_fn(spec16)
        rel["bf16"] = check_parity("bf16 plain eval", loss16(
            params16, batch16, GAMMA, SCALE)[0], ref, LOSS_TOL_BF16)
        ms["bf16_eval"] = time_ms(ev(loss16, params16, batch16), iters, dev)

    def nested_loss(p, b, gamma, scale):
        sums = nested_autograd_sums(p, b, gamma, scale, **phys)
        return k1.sums_to_total(p, b, scale, sums, spec.activation, **weights)

    with torch.no_grad():
        rel["nested"] = check_parity("nested-autograd eval", nested_loss(
            params, batch, GAMMA, SCALE)[0], ref, LOSS_TOL_F32)
    ms["nested_eval"] = time_ms(ev(nested_loss), max(1, iters // 4), dev)

    steps = {"train_step": (value_and_grad(loss_fn), False),
             "fused_train_step": (make_value_and_grad(
                 spec.layers, **phys, **weights), False),
             "fused_train_step_relaxed": (make_value_and_grad(
                 spec.layers, **phys, **weights, delayed=True,
                 fresh_values=True, extrapolate=True), True)}
    for name, (vag, stateful) in steps.items():
        ms[name], first = _train_ms(vag, params, batch, iters, dev, stateful)
        rel[name] = check_parity(name, first, ref, LOSS_TOL_F32)
    ms["dynamics_step"] = propagator_ms(evolve_gemm, dev, dyn_n, dyn_steps)

    rates = {f"{k}_pts_per_sec": per_sec(n, v, k) for k, v in ms.items()
             if k != "dynamics_step"}
    best_f32 = min(("xla_eval", "pallas_eval", "rowcat_eval"), key=ms.get)
    best_bf16 = min(("pallas_bf16_eval", "rowcat_bf16_eval"), key=ms.get)
    best_key = min((best_f32, best_bf16), key=ms.get)
    flops = matmul_flops(spec.layers, n, grad=False)
    share = lambda key, peak: flops / (ms[key] * 1e-3) / PEAK_FLOPS[peak]
    name, limit = card_info(dev)
    best = rates[f"{best_key}_pts_per_sec"]
    baseline = rates.pop("nested_eval_pts_per_sec")
    return {
        "metric": "gpe2d_loss_eval_pts_per_sec", "value": best,
        "unit": "collocation_pts/s", "vs_baseline": best / baseline,
        "baseline_pts_per_sec": baseline, "best_eval": best_key[:-len("_eval")],
        "device": name, "power_limit": limit, "n_pts": n,
        **rates,
        "best_eval_pts_per_sec": best,
        "dynamics_grid_pt_steps_per_sec": per_sec(dyn_n * dyn_n,
                                                  ms["dynamics_step"], "dynamics"),
        "eval_tflops": flops * best / n / 1e12,
        "eval_mfu_vs_f32_peak": share(best_f32, "f32"),
        "bf16_eval_mfu_vs_bf16_peak": share(best_bf16, "bf16"),
        "pallas_vs_xla_rel_err": rel["pallas"],
        "pallas_bf16_vs_xla_rel_err": rel["pallas_bf16"],
        "rowcat_vs_xla_rel_err": rel["rowcat"],
        "rowcat_bf16_vs_xla_rel_err": rel["rowcat_bf16"],
        "bf16_vs_xla_rel_err": rel["bf16"],
        "nested_vs_xla_rel_err": rel["nested"],
        "fused_train_step_rel_err": rel["fused_train_step"],
        "fused_train_step_relaxed_rel_err": rel["fused_train_step_relaxed"],
        "total_loss": ref,
        "ms": ms,
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    pin_full_f32()
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
