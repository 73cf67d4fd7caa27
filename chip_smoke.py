#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gpe_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from gpe_tpu_torch/csrc with nvcc and drives the
port's three paths on the card:

1. the 2D main path, `gpe2d_ground_state` (50,176 points, [2,128,128,128,1]
   shifted_tanh MLP): K1 and K2 held against their plain PyTorch versions
   and timed (kernel, plain version, a nested-autograd PyTorch expression of
   the same function, CUDA events), K2's layout kernel (its padded weight
   copies) against its plain version, then (c) the port's runner
   (`experiments/run.py`) on the registered config with a shortened schedule,
   its LM polish cut to 20 steps (timed) and the oracle score, plus short relaxed
   and exact fits, μ checked against the exact linear eigenvalue;
2. the packed-ensemble path, `harmonic_paper` (4,000 points, six runs of
   [1,64,64,64,1], modes 0–5): the run-mode K1 and K2 (K3) held against
   their plain versions and against six single-run launches, timed the same
   way, the layout kernel for six runs, then `train_plpinn_modes_packed` over
   all six modes with a shortened schedule, μ(γ=0) checked against 2n+1;
3. the fused-eval benchmark, `python -m gpe_tpu_torch.bench`'s shape (50,176
   points, [2,100,100,100,1]): K1 and K2 at width 100 against their plain
   versions; K4 (csrc/rowcat_eval.cu) against its plain version and against
   K1, at this shape and the main shape, timed; K1 and K4 with bf16 GEMM
   operands (bf16 tensor cores) against their bf16 plain versions and the
   f32 loss, timed at both shapes; the GEMM
   propagator against the FFT one on a 256² grid; then the benchmark itself,
   in-process with fewer repetitions, its JSON on a line of its own;
4. the main path's yardsticks: (a) the imaginary-time oracle on the card
   at the runner's settings against the JAX artifact's mu_ref
   (runs/gpe2d_ground_state/summary.json), timed; (b) the JAX-trained
   artifact (runs/gpe2d_ground_state/bundle.pkl) at full width through K1
   on its rebuilt bases; the float64 LM endgame from its polished params,
   which launches no kernel, timed.

5. the 1D families (4,000 points, [1,64,64,64,1] shifted_tanh, the
   paper's weights): (a) the runner's cross-potential branch on
   `mode0_all_potentials` (γ ∈ {0, 1, 2} of 11, 300 of 2001 epochs, 300
   pretrain steps): the harmonic, gravity-well and Gaussian-trap ramps on
   K1/K2, the hard-BC box on the plain path, μ(0) of the first three
   against their exact eigenvalues, and a gravity-well fit timed per step
   on K2 and on the plain autograd path; (b) `p3_gravity_well`'s six modes
   through `train_plpinn_modes_packed` on K3, μ(0) against −αₙ; (c) the
   JAX-trained `runs/mode0_all_potentials` bundles on rebuilt batches,
   through K1 (the box through the plain path), against the JAX package's
   f32 μ; (d) the runner's `fit` branch on `gpe2d_circle` (10,000 disk
   points, [2,100,100,100,1] tanh, 200 of 3000 epochs), which launches no
   kernel.
6. the method comparison at `harmonic_paper`'s shape: (a) `fit_ensemble`'s
   fused route (R = 5 at γ = 20, R = 6 at γ = 0…100 per run; 100 steps
   from pretrained params) against R single fits and, with the exact step,
   against the plain route (torch.func), K3 timed at both; the LM step
   with its CUDA-graph matvec against the op-by-op one; (b) the runner's
   compare branch on `multirun_box_mode0`, `multirun_harmonic_mode0` and
   `compare_harmonic_mode0` (300 epochs); (c) `paper_tables.run_family`
   on `p3_harmonic` mode 0 (Δγ = 20, 300 epochs), its oracle against the
   committed table's mu_ref.
7. the continuation and excited-state trainers: (a) the runner's
   beta_sweep branch on `vary_beta_gravity_well` (4,000 points,
   [1,64,64,64,1], all six β of 1…100, 300 epochs a rung) on the K2 route
   and on the autograd route, each μ against the exact β^(2/3)·|a₀|, the
   routes' 300-step μ against each other (bounds from the readings of
   `experiments/sweep_controls.py`), and over 10 steps of every rung from
   the same params, with two planted faults of the relaxed step that must
   fail that check, K1/K2 against their plain versions at β = 100 and the
   fused loss against autograd's there; (b) the other seven
   configs of the slice (the box sweeps, two-stage, p-ramp, both
   deflations, ReLoBRaLo) at full width and cut depth, none of which
   launches a kernel.
8. collocation-sharded training over torch.distributed, two gloo ranks on
   the one card (spawned by `experiments/mesh_check.run_cases`): (a) K2's
   psum-aware mode at the main shape, the exact and the default relaxed
   vag over two steps against the unsharded vags; (b) `fit(mesh=)` with the
   fused gradient, 200 steps, against the unsharded fused fit, timed with
   its all-reduces; (c) `fit_ensemble(mesh=)` of six runs at
   `harmonic_paper`'s shape on K3 against the unsharded ensembles of each
   rank's runs (and, in its first step, of all six); (d) the
   runner on `plpinn_sharded_dp` at cut depth on a world-size-1 NCCL mesh,
   μ(0) against 1; then K2 timed at one rank's shard (25,088 points).
9. the optimizer zoo, the curriculum and the Helmholtz family, which train
   by autograd and launch no kernel: (a) 10 fit steps of every optimizer
   of `make_optimizer` (and adam with reduce-on-plateau) at
   `different_optimizers_harmonic`'s full width and point count ([1,100,
   100,100,1], 4,000 points, η = 10, clip 1.0, the α schedule) on the card
   against the CPU from the same params and probes (loss histories at
   1e-4; AdaHessian, Sophia and L-BFGS in float64), each timed on the card; (b) the runner's optimizer sweep at cut
   depth (η ∈ {0, 10}, 50 epochs, seven optimizers); (c) the three
   Helmholtz configs through the runner (200 epochs, 20 L-BFGS and 10 LM
   steps).
10. DeepONet, the spectral-flow flagships, 3D and SNGD, which (but 10d's
   kernel rows and its 3D PL-PINN fit) launch no kernel: (a) the runner
   on `deeponet_harmonic` at full width (64 potentials × 512 points),
   300 pretraining and 300 fit steps, the nine held-out FDM oracle μ
   against the CPU's, 10 fit steps card against CPU, and μ of the fully
   pretrained operator against √β beside a planted fault; (b) the 2D
   flagship's pipeline (pretraining, the spectral-flow solver a γ, the
   driver's 384² oracle and ψ errors) at 224², [2,128,128,128,1], cut
   (300 + 20 pretraining steps, γ ∈ {2, 5}, 10 × 80 interleave steps,
   300 + 40 final steps, 5 LM steps), every L-BFGS step counted, the endgame's
   μ_grid against the oracle run from the linear ground state, and the
   interleave card against CPU at width 32; (c) the JAX flagships'
   params (runs/gpe2d_flagship, runs/gpe3d_ground_state) through the
   solver's `report` against the JAX package's CPU μ; (d) K1 and K2 at
   d = 3 (36³ points, [3,128,128,128,1]) against their plain versions,
   timed, the 3D PL-PINN path on them, and one spectral-flow rung at
   36³; (e) `make_sngd_solver` (2D) and `pretrain_sobolev` card against
   CPU.
11. K2's bf16 operand mode, the rotating frame and the time-dependent
   drivers: (a) K2-bf16 at the main shape and at the bench's width 100,
   K3-grads-bf16 and K3-sums-bf16 at harmonic_paper's six runs, against
   their bf16 plain versions (gradients 2e-4 normalised, sums 1e-4),
   against f32 K2 (1e-2) and beside a planted fault that must fail (the
   weights rounded in the forward, as K1's mode does), timed against a
   bound of the forward and backprop products at 989/3 and W̄ at 989
   TFLOP/s; then the bf16 path: 10 steps of `fit(value_and_grad_fn=)`
   (main shape) and `fit_ensemble` (six runs) with the relaxed bf16 vag,
   card against CPU (1e-3, from `bf16_fit_controls.py`'s sound routes and
   planted faults), beside the f32 route and the two planted faults,
   which must exceed it; (b) the JAX tests'
   rotating-frame oracles in float64 on the card (Kohn splitting, the f64
   ADI oracle, the remainder record, card against CPU); (c)
   `train_rotating_vortex` at full width ([2,128,128,128,2], n 128, Ω
   0.7), cut (300 + 20 distillation, 5 LM steps), its oracle's one vortex
   and L_z ≈ 1, the loss, its gradient and 20 Sobolev steps card against
   CPU; (d) rotating_dynamics, gpe_dynamics (f64 and --f32),
   gpe2d_vortex (Ω 0.9 from the committed oracle cache) and
   gpe2d_vortex_config at cut depth. 11b–d launch no kernel.
12. the `numeric:` bases and the optical-lattice drivers (BASELINE #4):
   (a) K1 and K2 at the lattice shape (16,384 points, [2,128,128,128,1],
   the γ = 0 state of runs/gpe2d_lattice/oracle_cache.npz as a sine-series
   base, timed at γ 5) against their plain versions; (b) that base at the
   16,384 points, card against CPU in float64; (c) lattice_summary.py's
   oracle (n 255, τ 2e-3, Richardson 2, γ 0) on the cache's V against the
   committed mu_ref, and the port's own V against the cache's;
   (d) gpe2d_lattice_plpinn's train_plpinn at full width, cut (ramp 0,
   0.5, 1.0 of 300 epochs, 20 LM steps and the float64 endgame at γ = 0):
   μ_lm(0) within 1e-2 of the oracle while a planted fault (the base's
   Laplacian zeroed) misses it, its K1/K2 launches the rows' (path
   "lattice"); (e) the lattice flagship's pipeline at one γ = 5 rung (the
   10b cut, bc "dirichlet"), lattice_gamma0_band's net stage from the
   committed band cache (300 Sobolev steps, 5 LM steps), and the JAX
   flagship's params through `report` against the JAX package's CPU μ.
   12c and 12e launch no kernel.
13. the split-step propagator with the grid in slabs
   (`dynamics/sharded.py:evolve_sharded`, two all-to-all transposes a
   step) over gloo ranks on the one card: float64 against the
   single-device `evolve` on the card in the three 2D cases of
   tests/test_dynamics_sharded.py (periodic real and imaginary time,
   Dirichlet) at 256² on two ranks and its 3D case at 64³ on four, in
   one spawn of four ranks (ψ 5e-13, observables rtol 1e-11), float32 at 256² (ψ 1e-5, μ 1e-5),
   a planted fault (the tiles received in reverse rank order) that must
   fail, and ms a step sharded, unsharded and of the all-to-alls. It
   launches no kernel.
14. the figures: (a) whether matplotlib imports on this host; (b) the
   runner's wavefunction gather (`run.wavefunctions_from_bundle`, the
   nets of runs/harmonic_quick/bundle.pkl on make_batch's grid) on the
   card against the CPU, max|Δu| ≤ 1e-5; (c) the `.npz` figure files that
   11d's drivers leave (rotating_dynamics, gpe_dynamics, gpe2d_vortex):
   present, finite and shaped as their draw functions take them, and each
   driver's record's `plot` (the PNGs, or where matplotlib does not import
   the note naming `--plots`); (d) where matplotlib imports, each driver's
   `--plots` draws from those files, each PNG non-empty. It launches no
   kernel.
15. the reports (`experiments/reference_compare.py`, `gamma0_anchor.py`)
   on the card's host, through `experiments/report_check.py`: both tables
   built from the committed runs/ and a reference tree written to a
   temporary directory (the reference cells the committed tables quote),
   their "ours" cells against runs/reference_parity/parity.md (33 rows)
   and gamma0_anchor.md (32 of 33 rows: its p3_gaussian mode-0 row is
   stale). It launches no kernel.

A kernel row's "ms" is device time: CUDA events around replays of a CUDA
graph of one wrapper call; "call_ms" is back-to-back calls, host work
included. Each path's launch counters are set to 0 just before it and read
just after. It stops every process it starts, and before it reports it
checks that none of them is left. Any failure exits non-zero. Output: the card's name and power limit,
one {"kernels": [...]} line, and a last line {"ok": true, "device": {...}}.

Needs a CUDA device; it imports nothing of JAX or of the gpe_tpu package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

# Published H100 SXM HBM3 bandwidth (NVIDIA data sheet); the operations
# peaks by GEMM operand type are gpe_tpu_torch.bench.PEAK_FLOPS (f32 rows:
# "tf32x3", the least time for f32-parity products on this card).
PEAK_HBM_BYTES = 3.35e12

K1_TOL = 1e-4       # relative, per sum: f32, other summation order/association
K2_TOL = 2e-4       # max |Δ| / max |g| per leaf (tests/test_pallas_grad.py's)
# bf16 operand modes against their bf16 plain versions, relative per sum:
# both round the same operands; an f32 value within f32 round-off of a bf16
# rounding boundary may round the other way on one side, a 2^-8 change of
# one term of one sum, so K1's f32 limit holds (1.1e-7 measured at the bench
# shape on the H100).
BF16_TOL = 1e-4
# GEMM vs FFT propagator in f32 over 300 steps, norm and μ, relative: the
# f32 propagators are unitary to round-off, so the norm drifts apart by
# ~1e-7 a step; tests/test_gemm_step.py allows 2e-3 over 1200 steps.
DYN_RTOL = 5e-4


def log(*a):
    print(*a, flush=True)


def check_no_children() -> None:
    """Raise if a process this script started (nvcc, the mesh's ranks,
    multiprocessing's resource tracker) is still there: the script stops
    every process it starts before it reports."""
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == os.getpid():
                with open(f"/proc/{pid}/cmdline") as f:
                    left.append(f"{pid}: {f.read().replace(chr(0), ' ').strip()}")
        except (OSError, ValueError, IndexError):
            continue
    if left:
        raise AssertionError(f"processes left running: {left}")


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


def kernel_ms(fn, iters: int):
    """(ms, call_ms) of a kernel wrapper's call: the device time per call,
    from CUDA-graph replays of one call (`bench.graph_ms`: the host work of
    the wrapper left out; its few tensor ops are in), and the time per
    back-to-back call by CUDA events, host work included (the run-mode calls
    are host-bound)."""
    import torch
    from gpe_tpu_torch.bench import graph_ms
    dev = torch.device("cuda", torch.cuda.current_device())
    return graph_ms(fn, iters, dev), time_ms(fn, iters)


def io_bytes(layers, n: int, grad: bool, runs: int = 1) -> float:
    """Bytes each input read once and each output written once: x (n·d),
    V, w (n each), each run's base value and Laplacian (n each), parameters
    and 4 sums and, for K2, its gradient (as large as its parameters)."""
    n_params = sum(k * m + m for k, m in zip(layers[:-1], layers[1:]))
    b = 4 * (n * layers[0] + 2 * n + runs * (2 * n + n_params + 4))
    return float(b + (4 * runs * n_params if grad else 0))


def bound(layers, n: int, grad: bool, runs: int = 1, operands: str = "tf32x3"):
    """(least ms, "operations" or "bytes"): the kernels' matmul FLOPs
    (`gpe_tpu_torch.bench.matmul_flops`, the count the benchmark uses) over
    the card's peak for their GEMM operands (f32: the dense TF32 tensor-core
    rate over three, 3xTF32's f32-parity rate; bf16: the dense bf16
    tensor-core rate), or their bytes over the HBM rate, the larger."""
    from gpe_tpu_torch.bench import PEAK_FLOPS, matmul_flops
    t_ops = runs * matmul_flops(layers, n, grad) / PEAK_FLOPS[operands] * 1e3
    t_mem = io_bytes(layers, n, grad, runs) / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


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


def phase_k1(spec, batch, params, timing=(5.0, 0.05)):
    """K1 against its plain version at three (γ, s), timed at `timing`."""
    import torch
    from gpe_tpu_torch.bench import nested_autograd_sums
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
    gamma, scale = timing
    nested = nested_autograd_sums(params, batch, gamma, scale, spec.activation,
                                  spec.p, spec.kinetic, spec.nonlinearity)
    plain = k1.collocation_sums_plain(params, *args, gamma, scale, *base, **kw)
    log(f"K1 nested-autograd sums vs plain: max rel "
        f"{float(((nested.detach() - plain).abs() / plain.abs()).max()):.2e}")
    ms, call_ms = kernel_ms(
        lambda: k1.collocation_sums(params, *args, gamma, scale, *base, **kw), 20)
    plain_ms = time_ms(lambda: k1.collocation_sums_plain(params, *args, gamma, scale,
                                                         *base, **kw), 10)
    lib_ms = time_ms(lambda: nested_autograd_sums(params, batch, gamma, scale,
                                                  spec.activation, spec.p,
                                                  spec.kinetic,
                                                  spec.nonlinearity), 5)
    n = batch["x"].shape[0]
    b_ms, b_by = bound(spec.layers, n, grad=False)
    log(f"K1 timing: kernel {ms:.4f} ms (per call {call_ms:.4f}), plain {plain_ms:.4f} "
        f"ms, nested autograd {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "fused_residual", "route": "cuda",
            "source": "gpe_tpu_torch/csrc/fused_residual.cu",
            "replaces": "gpe_tpu/pallas/fused_residual.py:246",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def _grad_err(got, want):
    """(max abs error, max over leaves — and over runs, for run-stacked
    grads — of max|Δ| / max|want|)."""
    worst_abs, worst_norm = 0.0, 0.0
    for (gw, gb), (ww, wb) in zip(got, want):
        rows = gw.shape[0] if gw.ndim == 3 else 1      # run-stacked: W (R, in, out)
        for a, b in ((gw, ww), (gb, wb)):
            d = (a - b).abs().reshape(rows, -1).amax(dim=1)
            m = b.abs().reshape(rows, -1).amax(dim=1) + 1e-30
            worst_abs = max(worst_abs, float(d.max()))
            worst_norm = max(worst_norm, float((d / m).max()))
    return worst_abs, worst_norm


def _check_layout(params, runs=None) -> bool:
    """K2's layout kernel (the padded W_l, W_lᵀ copies its launch writes
    first) against its plain version: a copy, so bit-equal."""
    import torch
    from gpe_tpu_torch.kernels import fused_grad as k2

    got = k2.padded_weights(params, runs)
    want = k2.padded_weights_plain(params, runs)
    torch.cuda.synchronize()
    equal = got.shape == want.shape and bool(torch.equal(got, want))
    log(f"K2 layout kernel{'' if runs is None else f' ({runs} runs)'}: "
        f"{tuple(got.shape)} floats, bit-equal to its plain version {equal}")
    if not equal:
        raise AssertionError("K2's layout kernel disagrees with its plain version")
    return equal


def phase_k2(spec, batch, params, timing=(5.0, 0.05)):
    """K2 against its plain version at three (γ, s) in the exact and the
    delayed modes, and its layout kernel; timed at `timing`."""
    import torch
    from gpe_tpu_torch.bench import nested_autograd_sums
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
    layout_equal = _check_layout(params)
    gamma, scale = timing
    sums = k1.collocation_sums(params, *args, gamma, scale, *base, **kw)
    cots = k1.sums_to_loss(sums, n, spec.norm_weight)[3]
    leaves = [t.detach().requires_grad_(True) for pair in params for t in pair]
    pairs = tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))

    def library():
        s = nested_autograd_sums(pairs, batch, gamma, scale, spec.activation,
                                 spec.p, spec.kinetic, spec.nonlinearity)
        return torch.autograd.grad(torch.sum(cots * s), leaves)

    ms, call_ms = kernel_ms(lambda: k2.collocation_grads(params, *args, gamma, scale,
                                                         cots, *base, **kw), 20)
    plain_ms = time_ms(lambda: k2.collocation_grads_plain(
        params, *args, gamma, scale, cots, *base, **kw), 10)
    lib_ms = time_ms(library, 3)
    b_ms, b_by = bound(spec.layers, n, grad=True)
    log(f"K2 timing: kernel {ms:.4f} ms (per call {call_ms:.4f}), plain {plain_ms:.4f} "
        f"ms, nested autograd {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "fused_grad", "route": "cuda",
            "source": "gpe_tpu_torch/csrc/fused_grad.cu",
            "replaces": "gpe_tpu/pallas/fused_grad.py:396",
            "max_abs_err": worst_abs, "layout_bit_equal": layout_equal, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


# Phase 1c's LM polish, cut from the config's 120 steps (1.17 s a step at
# 50,176 points: the polish took 141 s of a 1,180 s script on a slow
# host); no check reads its μ beyond finiteness, and phase 4 times the
# f64 endgame from the JAX artifact's polished params.
MAIN_LM_STEPS = 20


def phase_main_path(cfg, dev):
    """The port's main path at full width and point count, shortened: (c)
    the runner (`experiments/run.py`) on gpe2d_ground_state with two γ rungs
    of 300 epochs and 300 pretrain steps, the config's rebase and its LM
    polish cut to MAIN_LM_STEPS (timed), and the oracle, into a temporary
    --out — its summary has mu_ref and mu_abs_err, μ(0) is within 1e-2 of
    1, μ rises with γ, K1 and K2 launched; then short relaxed and exact fits
    from its γ=0 params, timed per step."""
    import tempfile

    from gpe_tpu_torch.experiments import run
    from gpe_tpu_torch.io import load_bundle
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import params_from_numpy
    from gpe_tpu_torch.train.problem import (make_batch, make_fused_value_and_grad,
                                             make_loss_fn)

    spec = cfg.spec
    k1.collocation_sums.launches = 0
    k2.collocation_grads.launches = 0
    with tempfile.TemporaryDirectory() as out:
        rc = run.main(["gpe2d_ground_state", "--train", "--epochs", "300", "--gammas",
                       "0", "5", "--pretrain", "300", "--lm-steps", str(MAIN_LM_STEPS),
                       "--out", out])
        exp = os.path.join(out, "gpe2d_ground_state")
        with open(os.path.join(exp, "summary.json")) as f:
            summary = json.load(f)
        bundle = load_bundle(os.path.join(exp, "bundle.pkl"))
    launches = {"fused_residual": k1.collocation_sums.launches,
                "fused_grad": k2.collocation_grads.launches}
    mus = dict(bundle["mu_table"][0])
    pol = summary["lm_polished"]["0"]
    sec = summary["seconds"]
    log(f"run.main rc {rc}, wall {summary['wall_s']} s: μ per γ {mus}; epochs "
        f"{bundle['epochs_history'][0]}; LM ({pol['steps']} steps) "
        f"{sec['lm']['0']:.2f} s, {sec['lm']['0'] / pol['steps']:.3f} s a step; "
        f"oracle {sec['oracle']['0']:.2f} s; LM-polished μ {pol['mu']:.7f} vs "
        f"μ_ref {pol['mu_ref']:.9f}: |Δ| {pol['mu_abs_err']:.3e}; launches {launches}")
    if rc != 0 or not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if not all(math.isfinite(m) for m in mus.values()) \
            or not all(math.isfinite(pol[k]) for k in ("mu", "mu_ref", "mu_abs_err")):
        raise AssertionError(f"non-finite μ: {mus}, {pol}")
    if abs(mus[0.0] - 1.0) > 1e-2:
        raise AssertionError(f"μ(γ=0) = {mus[0.0]} is not within 1e-2 of 1.0")
    if not mus[5.0] > mus[0.0]:
        raise AssertionError(f"μ(5) = {mus[5.0]} ≤ μ(0) = {mus[0.0]}")

    # per-step time of the default (relaxed) and the exact fused step
    batch = make_batch(spec, 0, device=dev)
    params = params_from_numpy(bundle["params_by_mode"][0][0.0], device=dev)
    scale = cfg.perturb_const / bundle["constant_history"][0]
    loss_fn = make_loss_fn(spec)
    steps = {}
    for name, relaxed in (("relaxed", None), ("exact", False)):
        vag = make_fused_value_and_grad(spec, device=dev, relaxed=relaxed)
        before = (k1.collocation_sums.launches, k2.collocation_grads.launches)
        steps[name], r = _fit_step_ms(loss_fn, params, batch, 0.0, scale, vag, cfg.lr)
        after = (k1.collocation_sums.launches, k2.collocation_grads.launches)
        log(f"fit ({name}): {steps[name]:.4f} ms/step, μ {r.mu_best:.7f}, "
            f"launches K1 {after[0] - before[0]} K2 {after[1] - before[1]}")
        if abs(r.mu_best - 1.0) > 1e-2 or after[1] - before[1] != 200:
            raise AssertionError(f"exact/relaxed fit off: μ {r.mu_best}")
        if name == "exact" and after[0] - before[0] < 200:
            raise AssertionError("the exact step did not run K1 every step")
    return launches, steps, sec


def runs_shape(dev):
    """The packed path's K3 inputs at full size: `harmonic_paper`'s 4,000
    points, one run per mode 0–5 of [1,64,64,64,1] from seeded generators,
    per-run γ, scale and Hermite bases."""
    import torch
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.models.mlp import init_mlp, stack_runs
    from gpe_tpu_torch.train.problem import make_batch

    cfg = EXPERIMENTS["harmonic_paper"]
    spec, modes = cfg.spec, cfg.modes
    R = len(modes)
    batch = make_batch(spec, modes[0], device=dev)
    per_mode = [make_batch(spec, m, device=dev) for m in modes]
    for k in ("base_val", "base_lap", "base_bval"):
        batch[k] = torch.stack([b[k] for b in per_mode]).contiguous()
    params = stack_runs([init_mlp(spec.layers, "xavier_uniform",
                                  generator=torch.Generator().manual_seed(100 + r),
                                  device=dev) for r in range(R)])
    gammas = torch.tensor([0.0, 0.5, 1.0, 2.0, 5.0, 10.0][:R], device=dev)
    scales = torch.tensor([0.01 * (1 + r) for r in range(R)], device=dev)
    return cfg, spec, batch, params, gammas, scales


def _nested_runs(params, batch, gammas, scales, spec):
    """The library yardstick of the run mode: nested autograd, run by run."""
    import torch
    from gpe_tpu_torch.bench import nested_autograd_sums
    from gpe_tpu_torch.models.mlp import run_slice

    out = []
    for r in range(scales.shape[0]):
        b = {"x": batch["x"], "V": batch["V"], "w": batch["w"],
             "base_val": batch["base_val"][r], "base_lap": batch["base_lap"][r]}
        out.append(nested_autograd_sums(run_slice(params, r), b, gammas[r],
                                        scales[r], spec.activation, spec.p,
                                        spec.kinetic, spec.nonlinearity))
    return torch.stack(out)


def phase_k3_sums(spec, batch, params, gammas, scales):
    """Run-mode K1 (K3) against its plain version and six single-run K1
    launches, timed."""
    import torch
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import run_slice

    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    args = (batch["x"], batch["V"], batch["w"], gammas, scales,
            batch["base_val"], batch["base_lap"])
    R = scales.shape[0]
    got = k1.collocation_sums_runs(params, *args, **kw)
    want = k1.collocation_sums_runs_plain(params, *args, **kw)
    singles = torch.stack([k1.collocation_sums(
        run_slice(params, r), batch["x"], batch["V"], batch["w"], gammas[r],
        scales[r], batch["base_val"][r], batch["base_lap"][r], **kw)
        for r in range(R)])
    torch.cuda.synchronize()
    ab = (got - want).abs()
    rel = float((ab / want.abs()).max())
    rel_single = float(((got - singles).abs() / singles.abs()).max())
    bit_equal = bool(torch.equal(got, singles))
    log(f"K3 sums ({R} runs): kernel {got.tolist()}")
    log(f"K3 sums vs plain max rel {rel:.2e}; vs {R} single-run K1 launches max "
        f"rel {rel_single:.2e}, bit-equal {bit_equal}")
    if not torch.isfinite(got).all() or rel > K1_TOL or rel_single > K1_TOL:
        raise AssertionError(f"run-mode K1 disagrees: plain {rel:.3e}, "
                             f"single runs {rel_single:.3e}")
    ms, call_ms = kernel_ms(lambda: k1.collocation_sums_runs(params, *args, **kw), 50)
    singles_ms, _ = kernel_ms(lambda: [k1.collocation_sums(
        run_slice(params, r), batch["x"], batch["V"], batch["w"], gammas[r],
        scales[r], batch["base_val"][r], batch["base_lap"][r], **kw)
        for r in range(R)], 20)
    plain_ms = time_ms(lambda: k1.collocation_sums_runs_plain(params, *args, **kw), 10)
    lib_ms = time_ms(lambda: _nested_runs(params, batch, gammas, scales, spec), 5)
    n = batch["x"].shape[0]
    b_ms, b_by = bound(spec.layers, n, grad=False, runs=R)
    log(f"K3 sums timing: kernel {ms:.4f} ms (per call {call_ms:.4f}), {R} single-run "
        f"K1 launches {singles_ms:.4f} ms, plain {plain_ms:.4f} ms, nested autograd "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "fused_residual_runs", "route": "cuda",
            "source": "gpe_tpu_torch/csrc/fused_residual.cu",
            "replaces": "gpe_tpu/pallas/fused_residual.py:246",
            "max_abs_err": float(ab.max()), "max_rel_err": rel,
            "bit_equal_to_single_runs": bit_equal, "ms": ms, "call_ms": call_ms,
            "single_runs_ms": singles_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def phase_k3_grads(spec, batch, params, gammas, scales):
    """Run-mode K2 (K3), exact and delayed cotangents, against its plain
    version and six single-run K2 launches, timed."""
    import torch
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import run_slice

    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    args = (batch["x"], batch["V"], batch["w"], gammas, scales)
    base = (batch["base_val"], batch["base_lap"])
    n, R = batch["x"].shape[0], scales.shape[0]
    sums = k1.collocation_sums_runs(params, *args, *base, **kw)
    cots = k1.sums_to_loss(sums, n, spec.norm_weight)[3]
    stale = k1.sums_to_loss(sums * torch.tensor([1.3, 0.9, 1.1, 0.8],
                                                device=sums.device),
                            n, spec.norm_weight)[3]
    worst_abs, bit_equal = 0.0, True
    for mode, c in (("exact", cots), ("delayed", stale)):
        got, s_got = k2.collocation_grads_runs(params, *args, c, *base, **kw)
        want, _ = k2.collocation_grads_runs_plain(params, *args, c, *base, **kw)
        singles = [k2.collocation_grads(
            run_slice(params, r), batch["x"], batch["V"], batch["w"], gammas[r],
            scales[r], c[r], batch["base_val"][r], batch["base_lap"][r], **kw)
            for r in range(R)]
        torch.cuda.synchronize()
        ab, norm = _grad_err(got, want)
        one = tuple((torch.stack([g[0][li][0] for g in singles]),
                     torch.stack([g[0][li][1] for g in singles]))
                    for li in range(len(got)))
        s_one = torch.stack([g[1] for g in singles])
        _, norm_one = _grad_err(got, one)
        equal = all(torch.equal(a, b) for (aw, ab_), (bw, bb) in zip(got, one)
                    for a, b in ((aw, bw), (ab_, bb))) and torch.equal(s_got, s_one)
        bit_equal = bit_equal and equal
        s_rel = float(((s_got - sums).abs() / sums.abs()).max())
        log(f"K3 grads {mode}: max|Δ| {ab:.3e}, normalised {norm:.2e} vs plain; "
            f"vs {R} single-run K2 launches normalised {norm_one:.2e}, bit-equal "
            f"{equal}; its sums vs run-mode K1 max rel {s_rel:.2e}")
        if (norm > K2_TOL or norm_one > K2_TOL or s_rel > K1_TOL
                or not math.isfinite(ab)):
            raise AssertionError(f"run-mode K2 disagrees ({mode}): plain {norm:.3e}, "
                                 f"single runs {norm_one:.3e}, sums {s_rel:.3e}")
        worst_abs = max(worst_abs, ab)
    layout_equal = _check_layout(params, R)
    leaves = [t.detach().requires_grad_(True) for pair in params for t in pair]
    pairs = tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))

    def library():
        s = _nested_runs(pairs, batch, gammas, scales, spec)
        return torch.autograd.grad(torch.sum(cots * s), leaves)

    ms, call_ms = kernel_ms(
        lambda: k2.collocation_grads_runs(params, *args, cots, *base, **kw), 50)
    singles_ms, _ = kernel_ms(lambda: [k2.collocation_grads(
        run_slice(params, r), batch["x"], batch["V"], batch["w"], gammas[r],
        scales[r], cots[r], batch["base_val"][r], batch["base_lap"][r], **kw)
        for r in range(R)], 20)
    plain_ms = time_ms(lambda: k2.collocation_grads_runs_plain(
        params, *args, cots, *base, **kw), 10)
    lib_ms = time_ms(library, 3)
    b_ms, b_by = bound(spec.layers, n, grad=True, runs=R)
    log(f"K3 grads timing: kernel {ms:.4f} ms (per call {call_ms:.4f}), {R} single-run "
        f"K2 launches {singles_ms:.4f} ms, plain {plain_ms:.4f} ms, nested autograd "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "fused_grad_runs", "route": "cuda",
            "source": "gpe_tpu_torch/csrc/fused_grad.cu",
            "replaces": "gpe_tpu/pallas/fused_grad.py:396",
            "max_abs_err": worst_abs, "bit_equal_to_single_runs": bit_equal,
            "layout_bit_equal": layout_equal, "ms": ms, "call_ms": call_ms,
            "single_runs_ms": singles_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def phase_packed_path(cfg, dev):
    """The packed-ensemble path at full width and point count, shortened:
    all six modes of `harmonic_paper` in one run-stacked ensemble."""
    import torch
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import params_from_numpy, stack_runs
    from gpe_tpu_torch.train.packed import (fit_ensemble_packed,
                                            train_plpinn_modes_packed)
    from gpe_tpu_torch.train.problem import make_batch

    spec, modes = cfg.spec, cfg.modes
    gammas, epochs = (0.0, 0.5, 1.0), 300
    k1.collocation_sums_runs.launches = 0
    k2.collocation_grads_runs.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_plpinn_modes_packed(spec, gamma_values=gammas, modes=modes,
                                    epochs=epochs, patience=cfg.patience,
                                    perturb_const=cfg.perturb_const, lr=cfg.lr,
                                    seed=cfg.seed, pretrain_epochs=300,
                                    check_every=100, rebase=True, device=dev,
                                    verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_residual_runs": k1.collocation_sums_runs.launches,
                "fused_grad_runs": k2.collocation_grads_runs.launches}
    steps = len(gammas) * epochs
    log(f"train_plpinn_modes_packed wall {wall:.2f} s, {steps} steps of "
        f"{len(modes)} runs; launches {launches}")
    for m in modes:
        log(f"  mode {m}: μ per γ {dict(res.mu_table[m])}")
    # once per step each, plus one K1 per γ for μ at the restored params
    if launches != {"fused_residual_runs": steps + len(gammas),
                    "fused_grad_runs": steps}:
        raise AssertionError(f"run-mode kernels not once per step: {launches}")
    for m in modes:
        mus = dict(res.mu_table[m])
        if not all(math.isfinite(v) for v in mus.values()):
            raise AssertionError(f"non-finite μ for mode {m}: {mus}")
        if abs(mus[0.0] - (2 * m + 1)) > 1e-2:
            raise AssertionError(f"mode {m}: μ(γ=0) = {mus[0.0]} is not within "
                                 f"1e-2 of {2 * m + 1}")
        if not mus[0.0] < mus[0.5] < mus[1.0]:
            raise AssertionError(f"mode {m}: μ does not rise with γ: {mus}")

    # ms per training step of the packed ensemble (exact two-kernel step)
    batch = make_batch(spec, modes[0], device=dev)
    per_mode = [make_batch(spec, m, device=dev) for m in modes]
    prb = {k: torch.stack([b[k] for b in per_mode])
           for k in ("base_val", "base_lap", "base_bval")}
    params = stack_runs([params_from_numpy(res.params_by_mode[m][1.0], device=dev)
                         for m in modes])
    scale = torch.tensor([cfg.perturb_const / res.constant_history[m] for m in modes],
                         device=dev)
    before = (k1.collocation_sums_runs.launches, k2.collocation_grads_runs.launches)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fit_ensemble_packed(spec, params, batch, 1.0, scale, epochs=200, tol=0.0,
                        patience=10 ** 9, check_every=100, lr=cfg.lr,
                        lr_mode="loss_faithful", per_run_base=prb)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / 200
    after = (k1.collocation_sums_runs.launches, k2.collocation_grads_runs.launches)
    log(f"fit_ensemble_packed ({len(modes)} runs, exact): {step_ms:.4f} ms/step, "
        f"launches K3 sums {after[0] - before[0]}, K3 grads {after[1] - before[1]}")
    return launches, {"packed_exact": step_ms}


def bench_shape(dev):
    """`python -m gpe_tpu_torch.bench`'s inputs: 224² points of the 2D
    harmonic trap, [2,100,100,100,1] shifted_tanh from init_mlp seed 0."""
    import torch
    from gpe_tpu_torch.bench import bench_spec
    from gpe_tpu_torch.models.mlp import init_mlp
    from gpe_tpu_torch.train.problem import make_batch

    spec = bench_spec()
    return spec, make_batch(spec, 0, device=dev), init_mlp(
        spec.layers, "xavier_uniform", generator=torch.Generator().manual_seed(0),
        device=dev)


def _sums_args(spec, batch, gamma, scale):
    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    return (batch["x"], batch["V"], batch["w"], gamma, scale,
            batch.get("base_val"), batch.get("base_lap")), kw


def _rel(got, want):
    return float(((got - want).abs() / want.abs()).max())


def phase_width100(spec, batch, params):
    """K1 and K2 at the bench's width 100 (not a multiple of 8) against
    their plain versions."""
    import torch
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1

    n = batch["x"].shape[0]
    for gamma, scale in ((5.0, 0.05), (100.0, 0.01)):
        args, kw = _sums_args(spec, batch, gamma, scale)
        got = k1.collocation_sums(params, *args, **kw)
        want = k1.collocation_sums_plain(params, *args, **kw)
        cots = k1.sums_to_loss(got, n, spec.norm_weight)[3]
        grads, s2 = k2.collocation_grads(params, *args[:5], cots, *args[5:], **kw)
        pgrads, _ = k2.collocation_grads_plain(params, *args[:5], cots, *args[5:], **kw)
        torch.cuda.synchronize()
        rel, (_, norm) = _rel(got, want), _grad_err(grads, pgrads)
        log(f"width 100 γ={gamma} s={scale}: K1 sums vs plain max rel {rel:.2e}; "
            f"K2 grads normalised {norm:.2e}, its sums vs K1 {_rel(s2, got):.2e}")
        if not torch.isfinite(got).all() or rel > K1_TOL or norm > K2_TOL:
            raise AssertionError(f"K1/K2 at width 100 disagree: {rel:.3e}, {norm:.3e}")


def phase_k4(spec, batch, params, label):
    """K4 against its plain version and K1 (rel ≤ 1e-4 per sum), timed as
    kernel, plain version and library (nested autograd)."""
    import torch
    from gpe_tpu_torch.bench import nested_autograd_sums
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.kernels import rowcat_eval as k4

    worst_abs = worst_rel = 0.0
    for gamma, scale in ((0.0, 0.01), (5.0, 0.05), (100.0, 0.01)):
        args, kw = _sums_args(spec, batch, gamma, scale)
        got = k4.collocation_sums(params, *args, **kw)
        want = k4.collocation_sums_plain(params, *args, **kw)
        ref = k1.collocation_sums(params, *args, **kw)
        torch.cuda.synchronize()
        rel, rel1 = _rel(got, want), _rel(got, ref)
        log(f"K4 {label} γ={gamma} s={scale}: kernel {got.tolist()} max rel vs "
            f"plain {rel:.2e}, vs K1 {rel1:.2e}")
        if not torch.isfinite(got).all() or rel > K1_TOL or rel1 > K1_TOL:
            raise AssertionError(f"K4 disagrees: plain {rel:.3e}, K1 {rel1:.3e}")
        worst_abs = max(worst_abs, float((got - want).abs().max()))
        worst_rel = max(worst_rel, rel)
    args, kw = _sums_args(spec, batch, 5.0, 0.05)
    ms, call_ms = kernel_ms(lambda: k4.collocation_sums(params, *args, **kw), 20)
    k1_ms, _ = kernel_ms(lambda: k1.collocation_sums(params, *args, **kw), 20)
    plain_ms = time_ms(lambda: k4.collocation_sums_plain(params, *args, **kw), 10)
    lib_ms = time_ms(lambda: nested_autograd_sums(params, batch, 5.0, 0.05, **kw), 5)
    b_ms, b_by = bound(spec.layers, batch["x"].shape[0], grad=False)
    log(f"K4 {label} timing: kernel {ms:.4f} ms (per call {call_ms:.4f}), K1 "
        f"{k1_ms:.4f} ms, plain {plain_ms:.4f} ms, nested autograd {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of it")
    return {"name": "rowcat_eval", "route": "cuda",
            "source": "gpe_tpu_torch/csrc/rowcat_eval.cu",
            "replaces": "gpe_tpu/pallas/rowcat_eval.py:180",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": ms,
            "call_ms": call_ms,
            "k1_ms": k1_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def phase_bf16(spec, batch, params, main):
    """K1 and K4 with bf16 GEMM operands against their bf16 plain versions
    (BF16_TOL per sum) and, as the benchmark checks, their loss within 0.1
    of the plain f32 loss; timed as kernel, bf16 plain version and library
    (nested autograd with bf16 parameters and inputs); bound at the bf16
    tensor-core peak. The kernels are timed at the main shape too (`main`:
    its spec, batch and params) as `main_shape_ms`; the log gives each
    time's share of its bound."""
    import torch
    from gpe_tpu_torch.bench import (GAMMA, LOSS_TOL_BF16, SCALE, bench_tile,
                                     nested_autograd_sums)
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.kernels import rowcat_eval as k4
    from gpe_tpu_torch.train.problem import make_loss_fn

    bf16 = torch.bfloat16
    mspec, mbatch, mparams = main
    _, kw = _sums_args(spec, batch, 0.0, 0.0)
    weights = dict(bc_weight=spec.bc_weight, norm_weight=spec.norm_weight)
    ref = float(make_loss_fn(spec)(params, batch, GAMMA, SCALE)[0])
    p16 = tuple((W.to(bf16), b.to(bf16)) for W, b in params)
    b16 = {k: v.to(bf16) for k, v in batch.items()}
    evals = {"fused_residual_bf16": (k1, k1.make_loss_eval(
                 spec.layers, **kw, **weights, compute_dtype=bf16),
                 "gpe_tpu/pallas/fused_residual.py:246"),
             "rowcat_eval_bf16": (k4, k4.make_rowcat_loss_eval(
                 spec.layers, **kw, **weights, compute_dtype=bf16,
                 tile=bench_tile(batch["x"].shape[0])),
                 "gpe_tpu/pallas/rowcat_eval.py:180")}
    rows = []
    for name, (mod, ev, replaces) in evals.items():
        worst_abs = worst_rel = 0.0
        for gamma, scale in ((5.0, 0.05), (GAMMA, SCALE)):
            args, _ = _sums_args(spec, batch, gamma, scale)
            got = mod.collocation_sums(params, *args, **kw, compute_dtype=bf16)
            want = mod.collocation_sums_plain(params, *args, **kw, compute_dtype=bf16)
            f32 = mod.collocation_sums_plain(params, *args, **kw)
            torch.cuda.synchronize()
            rel = _rel(got, want)
            log(f"{name} γ={gamma} s={scale}: kernel {got.tolist()} max rel vs "
                f"bf16 plain {rel:.2e}, vs f32 plain {_rel(got, f32):.2e}")
            if not torch.isfinite(got).all() or rel > BF16_TOL:
                raise AssertionError(f"{name} disagrees with its plain version: "
                                     f"{rel:.3e}")
            worst_abs = max(worst_abs, float((got - want).abs().max()))
            worst_rel = max(worst_rel, rel)
        loss = float(ev(params, batch, GAMMA, SCALE)[0])
        loss_rel = abs(loss - ref) / abs(ref)
        log(f"{name} loss {loss} vs plain f32 {ref}: rel {loss_rel:.2e}")
        if not loss_rel < LOSS_TOL_BF16:
            raise AssertionError(f"{name} loss off the f32 loss: {loss_rel:.3e}")
        args, _ = _sums_args(spec, batch, 5.0, 0.05)
        ms, call_ms = kernel_ms(lambda: mod.collocation_sums(params, *args, **kw,
                                                             compute_dtype=bf16), 20)
        plain_ms = time_ms(lambda: mod.collocation_sums_plain(
            params, *args, **kw, compute_dtype=bf16), 10)
        lib_ms = time_ms(lambda: nested_autograd_sums(p16, b16, 5.0, 0.05, **kw), 5)
        b_ms, b_by = bound(spec.layers, batch["x"].shape[0], grad=False,
                           operands="bf16")
        margs, mkw = _sums_args(mspec, mbatch, 5.0, 0.05)
        main_ms, _ = kernel_ms(lambda: mod.collocation_sums(
            mparams, *margs, **mkw, compute_dtype=bf16), 20)
        main_b_ms, _ = bound(mspec.layers, mbatch["x"].shape[0], grad=False,
                             operands="bf16")
        log(f"{name} timing: kernel {ms:.4f} ms (per call {call_ms:.4f}), bf16 plain "
            f"{plain_ms:.4f} ms, nested autograd in bf16 {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of it; main shape "
            f"{main_ms:.4f} ms, bound {main_b_ms:.4f} ms, {100 * main_b_ms / main_ms:.1f}%")
        rows.append({"name": name, "route": "cuda",
                     "source": f"gpe_tpu_torch/csrc/{mod.__name__.split('.')[-1]}.cu",
                     "replaces": replaces, "max_abs_err": worst_abs,
                     "max_rel_err": worst_rel, "loss_vs_f32_rel_err": loss_rel,
                     "ms": ms, "call_ms": call_ms, "main_shape_ms": main_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms})
    return rows


def phase_dynamics(dev, n: int = 256, steps: int = 300):
    """evolve_gemm against evolve (f32, periodic, harmonic trap, γ = 100) on
    the benchmark's n² grid: norm and μ within DYN_RTOL; both engines' rates
    per step, host set-up excluded (`bench.propagator_ms`)."""
    import numpy as np
    from gpe_tpu_torch.bench import GAMMA, dynamics_grid, per_sec, propagator_ms
    from gpe_tpu_torch.dynamics import evolve, evolve_gemm

    psi, V, dx, lb = dynamics_grid(n)
    engines = {"gemm": evolve_gemm, "fft": evolve}
    (pg, og), (pf, of) = (fn(psi, V, dx, 1e-3, steps, GAMMA, bc="periodic", lb=lb,
                             record_every=100, device=dev)
                          for fn in engines.values())
    rel = {k: float(np.max(np.abs(og[k] - of[k]) / np.abs(of[k])))
           for k in ("norm", "mu")}
    psi_err = float((pg - pf).abs().max())
    rate = {k: per_sec(n * n, propagator_ms(fn, dev, n, 100), k)
            for k, fn in engines.items()}
    log(f"dynamics {n}² f32, {steps} steps: evolve_gemm vs evolve max rel "
        f"{rel}, max|Δψ| {psi_err:.2e}; μ {og['mu'][-1]:.6f} / {of['mu'][-1]:.6f}; "
        f"grid-pt·steps/s gemm {rate['gemm']:.4e}, fft {rate['fft']:.4e}")
    if not all(v <= DYN_RTOL for v in rel.values()) or not np.isfinite(psi_err):
        raise AssertionError(f"evolve_gemm disagrees with evolve: {rel}")
    return rate


def phase_bench(dev):
    """The fused-eval benchmark, in-process at full width with fewer
    repetitions; every counter set to 0 just before and read just after."""
    from gpe_tpu_torch import bench
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.kernels import rowcat_eval as k4

    counters = {"fused_residual": (k1.collocation_sums, "launches"),
                "fused_residual_bf16": (k1.collocation_sums, "bf16_launches"),
                "fused_grad": (k2.collocation_grads, "launches"),
                "rowcat_eval": (k4.collocation_sums, "launches"),
                "rowcat_eval_bf16": (k4.collocation_sums, "bf16_launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    rec = bench.measure(device=dev, iters=10, dyn_steps=100)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    log(json.dumps(rec))
    log(f"bench launches {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the benchmark never launched: {launches}")
    return launches


ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                        "gpe2d_ground_state")
# μ of the JAX-trained artifact's γ=100 rung and of its LM-polished params
# on the rebuilt bases, by the JAX package in f32 on a CPU (matmul precision
# "highest"; tests/test_torch_io.py holds the port's plain path to the JAX
# package's in the same rebuild); the artifact itself records 5.7628779 and
# 5.7596231, computed on the TPU
BUNDLE_MU = {"rung": 5.76025867, "polished": 5.75733757}
BUNDLE_RTOL = 1e-5
CROSS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                     "mode0_all_potentials")
# μ of the JAX-trained cross-potential bundles' γ=10 params on rebuilt
# batches, by the JAX package in f32 on a CPU (matmul precision "highest");
# tests/test_torch_families_train.py computes them with JAX and holds these
# digits to them. The runs' own summary records 4.0242014, 24.113070,
# 5.1596880 and 1.4795735, computed on the TPU.
CROSS_BUNDLE_MU = {"harmonic": 4.024077415466309, "box": 24.11325454711914,
                   "gravity_well": 5.161096572875977, "gaussian": 1.4791821241378784}
ORACLE_ATOL = 1e-8  # the float64 oracle against the artifact's mu_ref


def phase_oracle(dev):
    """(a) The imaginary-time oracle on the card at the runner's settings
    (384², τ 2e-3, Richardson order 2, γ = 100), within ORACLE_ATOL of the
    JAX artifact's mu_ref; timed."""
    import torch
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.experiments.run import oracle_mu

    with open(os.path.join(ARTIFACT, "summary.json")) as f:
        want = json.load(f)["lm_polished"]["0"]["mu_ref"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mu = oracle_mu(EXPERIMENTS["gpe2d_ground_state"].spec, 100.0, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"oracle on the card: μ_ref {mu!r} in {wall:.2f} s; artifact {want!r}, "
        f"|Δ| {abs(mu - want):.3e}")
    if not abs(mu - want) <= ORACLE_ATOL:
        raise AssertionError(f"the oracle gives {mu}, the artifact {want}")
    return wall


def phase_bundle(cfg, dev):
    """(b) The JAX-trained artifact at full width through K1: the γ=100
    rung's params on the base folded with the 7 rungs before it, the
    LM-polished params on the base folded with all 8 (train_plpinn rebases
    after every rung), μ from K1's sums against BUNDLE_MU. Returns the
    polished params, the 8-fold batch and the scale for the f64 check."""
    import torch
    from gpe_tpu_torch.io import load_bundle
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import params_from_numpy
    from gpe_tpu_torch.train.plpinn import _rebase
    from gpe_tpu_torch.train.problem import make_batch, make_loss_fn

    spec = cfg.spec
    bundle = load_bundle(os.path.join(ARTIFACT, "bundle.pkl"))
    rungs = sorted(bundle["params_by_mode"][0])
    scale = cfg.perturb_const / bundle["constant_history"][0]
    batch = make_batch(spec, 0, device=dev)
    n = batch["x"].shape[0]
    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    loss_fn = make_loss_fn(spec)
    gen = torch.Generator().manual_seed(0)

    def mus(params, gamma):
        sums = k1.collocation_sums(params, batch["x"], batch["V"], batch["w"], gamma,
                                   scale, batch["base_val"], batch["base_lap"], **kw)
        with torch.no_grad():
            plain = float(loss_fn(params, batch, gamma, scale)[1]["mu"])
        return float(k1.sums_to_loss(sums, n, spec.norm_weight)[0]), plain

    got = {}
    for g in rungs:
        params = params_from_numpy(bundle["params_by_mode"][0][g], device=dev)
        if g == rungs[-1]:
            got["rung"] = mus(params, g)
        batch, _ = _rebase(spec, batch, params, scale, gen)
    polished = params_from_numpy(bundle["polished"][0]["params"], device=dev)
    got["polished"] = mus(polished, rungs[-1])
    for k, (mu, plain) in got.items():
        rel = abs(mu - BUNDLE_MU[k]) / BUNDLE_MU[k]
        log(f"artifact {k} params on the rebuilt base, γ={rungs[-1]:g}: μ by K1 "
            f"{mu:.8f}, plain {plain:.8f}, want {BUNDLE_MU[k]} (rel {rel:.2e}); "
            f"the bundle records {bundle['mu_table'][0][-1][1] if k == 'rung' else bundle['polished'][0]['mu']}")
        if not rel <= BUNDLE_RTOL:
            raise AssertionError(f"artifact {k}: μ {mu} vs {BUNDLE_MU[k]}")
    return polished, batch, scale, rungs[-1]


def phase_polish_x64(spec, params, batch, scale, gamma):
    """The float64 endgame (lm_polish_x64 + _eval_mu_x64) on the card at the
    main shape, from the artifact's polished params: runs on the plain
    autograd path, so neither fused kernel launches; timed."""
    import torch
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.train.gauss_newton import lm_polish_x64, make_gpe_residual_fn
    from gpe_tpu_torch.train.plpinn import _eval_mu_x64
    from gpe_tpu_torch.train.problem import make_loss_fn

    counters = [(k1.collocation_sums, "launches"), (k1.collocation_sums, "bf16_launches"),
                (k2.collocation_grads, "launches")]
    before = [getattr(fn, a) for fn, a in counters]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lm_polish_x64(make_gpe_residual_fn(spec), params, batch, gamma, scale,
                        steps=2, cg_iters=20)
    mu = _eval_mu_x64(make_loss_fn(spec), res.params, batch, gamma, scale)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = [getattr(fn, a) - b for (fn, a), b in zip(counters, before)]
    log(f"f64 LM endgame (2 steps, 20 CG iterations) on the card: {wall:.2f} s, "
        f"loss {res.loss_history.tolist()}, μ (f64) {mu:.9f}; K1/K1-bf16/K2 "
        f"launches {launched}")
    if any(launched) or not math.isfinite(mu) or res.params[0][0].dtype != torch.float64:
        raise AssertionError(f"the f64 polish went through a kernel or failed: "
                             f"{launched}, μ {mu}")
    return wall


CROSS_EXACT = {"harmonic": 1.0, "box": math.pi ** 2, "gravity_well": 2.338107712}
CROSS_ATOL = 1e-2    # |μ(γ=0) − exact|: the pretrained base is the exact state


def _fit_step_ms(loss_fn, params, batch, gamma, scale, vag, lr, steps=200):
    """ms per fit() step over `steps` steps (CUDA events around the call)."""
    import torch
    from gpe_tpu_torch.train.loop import fit
    from gpe_tpu_torch.train.plpinn import ramp_optimizer

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fit(loss_fn, ramp_optimizer(lr), params, batch, gamma, scale, epochs=steps,
              tol=-1.0, patience=10 ** 9, check_every=100, value_and_grad_fn=vag)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps, res


def phase_cross_potential(dev):
    """(a) The runner's cross-potential branch on `mode0_all_potentials`, γ ∈
    {0, 1, 2}, 300 epochs, 300 pretrain steps, into a temporary --out: per
    family μ(0) within CROSS_ATOL of its exact eigenvalue (the Gaussian
    trap: finite, its distance to the FDM eigenvalue printed), μ rising
    with γ, K1 and K2 launched for every family but the hard-BC box, which
    launches neither. Then 200 steps of the gravity well's γ=1 fit from its
    trained params, timed on K2 (the default relaxed step) and on the plain
    autograd path (what GPE_TPU_TORCH_NO_FUSED=1 selects)."""
    import tempfile

    import numpy as np
    import torch
    from gpe_tpu_torch.experiments import run
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.io import load_bundle
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import params_from_numpy
    from gpe_tpu_torch.physics import potentials
    from gpe_tpu_torch.train.problem import (make_batch, make_fused_value_and_grad,
                                             make_loss_fn)
    from gpe_tpu_torch.validate.fdm import linear_eigensolve_1d

    cfg = EXPERIMENTS["mode0_all_potentials"]
    fams = run.cross_potential_families(cfg.spec)
    k1.collocation_sums.launches = 0
    k2.collocation_grads.launches = 0
    with tempfile.TemporaryDirectory() as out:
        rc = run.main(["mode0_all_potentials", "--train", "--epochs", "300", "--gammas",
                       "0", "1", "2", "--pretrain", "300", "--out", out])
        exp = os.path.join(out, "mode0_all_potentials")
        with open(os.path.join(exp, "summary.json")) as f:
            records = {r["potential"]: r for r in json.load(f)}
        bundles = {k: load_bundle(os.path.join(exp, f"{k}_bundle.pkl")) for k in fams}
    launches = {"fused_residual": k1.collocation_sums.launches,
                "fused_grad": k2.collocation_grads.launches}
    log(f"cross-potential run.main rc {rc}; launches {launches}")
    for label, rec in records.items():
        mus = dict(bundles[label]["mu_table"][0])
        log(f"  {label}: μ per γ {mus}; epochs {bundles[label]['epochs_history'][0]}; "
            f"seconds {rec['seconds']}; launches {rec['launches']}")
        if not all(math.isfinite(v) for v in mus.values()):
            raise AssertionError(f"{label}: non-finite μ {mus}")
        if not mus[0.0] < mus[1.0] < mus[2.0]:
            raise AssertionError(f"{label}: μ does not rise with γ: {mus}")
        counts = rec["launches"]
        if not (all(v > 0 for v in counts.values()) if label != "box"
                else not any(counts.values())):
            raise AssertionError(f"{label}: launches {counts}")
        if label in CROSS_EXACT:
            err = abs(mus[0.0] - CROSS_EXACT[label])
            log(f"  {label}: |μ(0) − {CROSS_EXACT[label]:.9f}| = {err:.3e}")
            if not err < CROSS_ATOL:
                raise AssertionError(f"{label}: μ(0) {mus[0.0]} off the exact value")
    spec = fams["gaussian"]
    x = np.linspace(spec.lb, spec.ub, 2003)[1:-1]
    V = potentials.get_potential(spec.potential)(torch.as_tensor(x))
    mu_fdm = float(linear_eigensolve_1d(V, x[1] - x[0], k=1, device=dev)[0][0])
    mu0 = dict(bundles["gaussian"]["mu_table"][0])[0.0]
    log(f"  gaussian: μ(0) {mu0:.7f}, FDM {mu_fdm:.7f}, |Δ| {abs(mu0 - mu_fdm):.3e} "
        "(no bound: the Hermite base is not this trap's eigenfunction)")
    if rc != 0 or set(records) != set(fams):
        raise AssertionError(f"cross-potential branch: rc {rc}, records {list(records)}")

    gspec = fams["gravity_well"]
    gb = bundles["gravity_well"]
    batch = make_batch(gspec, 0, device=dev)
    params = params_from_numpy(gb["params_by_mode"][0][1.0], device=dev)
    scale = cfg.perturb_const / gb["constant_history"][0]
    loss_fn = make_loss_fn(gspec)
    steps = {}
    for name, vag in (("gravity_well_k2", make_fused_value_and_grad(gspec, device=dev)),
                      ("gravity_well_autograd", None)):
        before = k2.collocation_grads.launches
        steps[name], r = _fit_step_ms(loss_fn, params, batch, 1.0, scale, vag, cfg.lr)
        n2 = k2.collocation_grads.launches - before
        log(f"gravity-well fit γ=1 ({name}): {steps[name]:.4f} ms/step, μ "
            f"{r.mu_best:.7f}, K2 launches {n2}")
        if (vag is None) != (n2 == 0) or not math.isfinite(r.mu_best):
            raise AssertionError(f"gravity-well fit ({name}) went the wrong way: {n2}")
    return launches, steps


def phase_gravity_packed(dev):
    """(b) `p3_gravity_well`'s six modes in one run-stacked ensemble (K3),
    γ ∈ {0, 0.5, 1}, 300 epochs, 300 pretrain steps, rebase: K3 launched,
    |μₙ(0) + αₙ| < CROSS_ATOL for n = 0..5, μ rising with γ."""
    import torch
    from gpe_tpu_torch.experiments.paper_tables import family
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.physics.bases import airy_zero
    from gpe_tpu_torch.train.packed import train_plpinn_modes_packed

    fam = family("p3_gravity_well")
    gammas = (0.0, 0.5, 1.0)
    k1.collocation_sums_runs.launches = 0
    k2.collocation_grads_runs.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_plpinn_modes_packed(fam["spec"], gamma_values=gammas, modes=fam["modes"],
                                    epochs=300, pretrain_epochs=300, check_every=100,
                                    rebase=True, device=dev, verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_residual_runs": k1.collocation_sums_runs.launches,
                "fused_grad_runs": k2.collocation_grads_runs.launches}
    log(f"p3_gravity_well packed ({len(fam['modes'])} modes): wall {wall:.2f} s, "
        f"launches {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"K3 never launched on the gravity-well ensemble: {launches}")
    for m in fam["modes"]:
        mus = dict(res.mu_table[m])
        err = abs(mus[0.0] + airy_zero(m))
        log(f"  mode {m}: μ per γ {mus}, |μ(0) + α{m}| {err:.3e}")
        if not err < CROSS_ATOL or not mus[0.0] < mus[0.5] < mus[1.0]:
            raise AssertionError(f"mode {m}: μ {mus} against −α = {-airy_zero(m)}")
    return launches, wall


def phase_cross_bundles(dev):
    """(c) The JAX-trained cross-potential bundles' γ=10 params on batches
    rebuilt on the card: μ within BUNDLE_RTOL of CROSS_BUNDLE_MU, through
    K1 (each sum within K1_TOL of K1's plain version) for the three
    non-hard-BC families, through the plain path for the box."""
    import torch
    from gpe_tpu_torch.experiments import run
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.io import load_bundle
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import params_from_numpy
    from gpe_tpu_torch.train.problem import make_batch, make_loss_fn

    cfg = EXPERIMENTS["mode0_all_potentials"]
    for label, spec in run.cross_potential_families(cfg.spec).items():
        bundle = load_bundle(os.path.join(CROSS, f"{label}_bundle.pkl"))
        g = sorted(bundle["params_by_mode"][0])[-1]
        scale = cfg.perturb_const / bundle["constant_history"][0]
        params = params_from_numpy(bundle["params_by_mode"][0][g], device=dev)
        batch = make_batch(spec, 0, device=dev)
        before = k1.collocation_sums.launches
        if spec.hard_bc:
            with torch.no_grad():
                mu = float(make_loss_fn(spec)(params, batch, g, scale)[1]["mu"])
            how, rel = "plain path", 0.0
        else:
            args, kw = _sums_args(spec, batch, g, scale)
            sums = k1.collocation_sums(params, *args, **kw)
            rel = _rel(sums, k1.collocation_sums_plain(params, *args, **kw))
            mu = float(k1.sums_to_loss(sums, batch["x"].shape[0], spec.norm_weight)[0])
            how = "K1"
        launched = k1.collocation_sums.launches - before
        mu_rel = abs(mu - CROSS_BUNDLE_MU[label]) / CROSS_BUNDLE_MU[label]
        log(f"cross bundle {label} γ={g:g}: μ by {how} {mu:.8f}, want "
            f"{CROSS_BUNDLE_MU[label]} (rel {mu_rel:.2e}); K1 vs plain max rel "
            f"{rel:.2e}; K1 launches {launched}; the bundle records "
            f"{bundle['mu_table'][0][-1][1]}")
        if not mu_rel <= BUNDLE_RTOL or rel > K1_TOL \
                or launched != (0 if spec.hard_bc else 1):
            raise AssertionError(f"cross bundle {label}: μ {mu}, K1 rel {rel}, "
                                 f"launches {launched}")


def phase_fit_circle(dev):
    """(d) The runner's `fit` branch on `gpe2d_circle` (10,000 disk points,
    [2,100,100,100,1] tanh, γ = 10), 200 of 3000 epochs, into a temporary
    --out: the best loss finite and below the initial params' loss, no K1
    or K2 launch (the disk is not fused, as in the JAX package)."""
    import tempfile

    import torch
    from gpe_tpu_torch.experiments import run
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.train.problem import init_params, make_batch, make_loss_fn

    cfg = EXPERIMENTS["gpe2d_circle"]
    spec = cfg.spec
    with torch.no_grad():
        loss0 = float(make_loss_fn(spec)(
            init_params(spec, torch.Generator().manual_seed(cfg.seed), device=dev),
            make_batch(spec, 0, device=dev), cfg.gamma_values[0], 1.0)[0])
    k1.collocation_sums.launches = 0
    k2.collocation_grads.launches = 0
    with tempfile.TemporaryDirectory() as out:
        rc = run.main(["gpe2d_circle", "--train", "--epochs", "200", "--out", out])
        with open(os.path.join(out, "gpe2d_circle", "summary.json")) as f:
            rec = json.load(f)
    launched = k1.collocation_sums.launches + k2.collocation_grads.launches
    sec = rec["seconds"]["fit"]
    log(f"fit branch gpe2d_circle: rc {rc}, γ {rec['gamma']}, μ {rec['mu']:.7f}, best "
        f"loss {rec['loss']:.6e} from {loss0:.6e}, {rec['epochs']} epochs in "
        f"{sec:.2f} s ({1e3 * sec / rec['epochs']:.3f} ms/step); K1/K2 launches "
        f"{launched}")
    if rc != 0 or launched or any(rec["launches"].values()) \
            or not math.isfinite(rec["loss"]) or not rec["loss"] < loss0 \
            or rec["epochs"] != 200:
        raise AssertionError(f"the fit branch failed: {rec}, launches {launched}")
    return sec


# the comparison phase (6): tests/test_torch_train.py's fit parity bounds
# (loss rtol 1e-4, μ 1e-5). Two comparisons hold the loss at 1e-3: the fused
# exact step against the plain route's autograd (the fused loss comes from
# the four sums, whose pde term cancels digits; tests/test_torch_cuda.py),
# and the per-run-γ ensemble against its single fits, whose γ = 0 run starts
# at the exact base, where the loss-as-step LR kicks it around and the
# batched GEMMs' round-off grows to 7.5e-4 in 100 steps (μ stays within
# 1e-5)
ENS_LOSS_RTOL, ENS_MU_RTOL, ENS_LOOSE_LOSS_RTOL = 1e-4, 1e-5, 1e-3
ORACLE_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                          "comparison_results_p3_harmonic", "raw_comparison_results.csv")


def _runs_counters():
    from gpe_tpu_torch.kernels._common import LaunchCounter
    return LaunchCounter(runs=True)


def _close(name, got, want, rtol):
    """Max relative difference of got from want; raises over rtol."""
    import numpy as np
    rel = np.abs(np.asarray(got) / np.asarray(want) - 1.0)
    per_run = np.round(rel.max(axis=-1), 9).tolist()
    log(f"  {name}: max rel {rel.max():.3e} (per run {per_run})")
    if not rel.max() <= rtol:
        raise AssertionError(f"{name}: max rel {rel.max():.3e} over {rtol:g}")
    return float(rel.max())


def phase_fit_ensemble(dev):
    """(a) `fit_ensemble`'s fused route at `harmonic_paper`'s shape (4,000
    points, [1,64,64,64,1]), 100 steps from params pretrained 300 steps
    (seeds 42…47, per-run q-scales): R = 5 at γ = 20 and R = 6 at γ = 0, 20,
    …, 100 per run, each with the default relaxed step against R single
    `fit`s (K2); R = 6 also with the exact step against the plain route
    (torch.func). Launches of each relaxed ensemble: K3 grads 100, K3 sums
    1, no single-run launch. Then K3's device time per launch at both
    shapes, on the ensemble's inputs."""
    import torch
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import init_mlp, run_slice, stack_runs
    from gpe_tpu_torch.train.compare import _pretrain_perturbation
    from gpe_tpu_torch.train.loop import fit, fit_ensemble
    from gpe_tpu_torch.train.plpinn import ramp_optimizer
    from gpe_tpu_torch.train.problem import (make_batch, make_fused_value_and_grad,
                                             make_loss_fn)

    cfg = EXPERIMENTS["harmonic_paper"]
    spec = cfg.spec
    batch = make_batch(spec, 0, device=dev)
    loss_fn = make_loss_fn(spec)
    relaxed = make_fused_value_and_grad(spec, device=dev)
    seeds = []
    for s in range(6):
        p = init_mlp(spec.layers, "xavier_uniform",
                     generator=torch.Generator().manual_seed(42 + s), device=dev)
        seeds.append(_pretrain_perturbation(spec, p, batch, 0, 300, cfg.perturb_const))
    kw = dict(epochs=100, tol=0.0, patience=10 ** 9, check_every=100)
    counter = _runs_counters()
    out, rows = {}, {}
    for R, gammas in ((5, [20.0] * 5), (6, [20.0 * r for r in range(6)])):
        label = "R5" if R == 5 else "R6_per_run_gamma"
        pb = stack_runs([p for p, _ in seeds[:R]])
        scales = [q for _, q in seeds[:R]]
        counter.mark()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ens = fit_ensemble(loss_fn, ramp_optimizer(cfg.lr), pb, batch,
                           gammas if R == 6 else 20.0, scales,
                           value_and_grad_fn=relaxed, **kw)
        end.record()
        end.synchronize()
        launches = counter.since()
        step_ms = start.elapsed_time(end) / 100
        want = {"fused_residual": 0, "fused_grad": 0, "fused_residual_runs": 1,
                "fused_grad_runs": 100}
        if launches != want:
            raise AssertionError(f"fit_ensemble {label}: launches {launches}, want {want}")
        singles = [fit(loss_fn, ramp_optimizer(cfg.lr), run_slice(pb, r), batch,
                       gammas[r], scales[r], value_and_grad_fn=relaxed, **kw)
                   for r in range(R)]
        worst = [_close(f"{label} loss", ens.loss_history,
                        [o.loss_history for o in singles],
                        ENS_LOSS_RTOL if R == 5 else ENS_LOOSE_LOSS_RTOL),
                 _close(f"{label} μ", ens.mu_history, [o.mu_history for o in singles],
                        ENS_MU_RTOL)]
        log(f"fit_ensemble {label} (relaxed): {step_ms:.4f} ms/step, launches {launches}; "
            f"vs {R} single fits max rel loss {worst[0]:.2e}, μ {worst[1]:.2e}; μ_best "
            f"{[round(float(m), 7) for m in ens.mu_best]}")
        rows[label] = {"step_ms": step_ms, "vs_single_fits": worst}
        if R == 6:
            exact = make_fused_value_and_grad(spec, device=dev, relaxed=False)
            fused = fit_ensemble(loss_fn, ramp_optimizer(cfg.lr), pb, batch, gammas,
                                 scales, value_and_grad_fn=exact, **kw)
            start.record()
            plain = fit_ensemble(loss_fn, ramp_optimizer(cfg.lr), pb, batch, gammas,
                                 scales, **kw)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end) / 100
            mu_rel = _close("exact vs plain route μ", fused.mu_history, plain.mu_history,
                            ENS_MU_RTOL)
            loss_rel = _close("exact vs plain route loss", fused.loss_history,
                              plain.loss_history, ENS_LOOSE_LOSS_RTOL)
            log(f"fit_ensemble {label}: exact fused vs plain route (torch.func, "
                f"{plain_ms:.4f} ms/step) max rel μ {mu_rel:.2e}, loss {loss_rel:.2e}")
            rows[label].update(plain_route_step_ms=plain_ms,
                               exact_vs_plain=[mu_rel, loss_rel])
        # K3's device time per launch on this ensemble's inputs
        kk = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
                  nonlinearity=spec.nonlinearity)
        g = torch.tensor(gammas, device=dev)
        sc = torch.tensor(scales, device=dev)
        args = (ens.params, batch["x"], batch["V"], batch["w"], g, sc)
        base = (batch["base_val"], batch["base_lap"])
        sums = k1.collocation_sums_runs(*args, *base, **kk)
        cots = k1.sums_to_loss(sums, batch["x"].shape[0], spec.norm_weight)[3]
        s_ms, s_call = kernel_ms(lambda: k1.collocation_sums_runs(*args, *base, **kk), 50)
        g_ms, g_call = kernel_ms(
            lambda: k2.collocation_grads_runs(*args, cots, *base, **kk), 50)
        log(f"K3 at {label}: sums {s_ms:.4f} ms (per call {s_call:.4f}), grads "
            f"{g_ms:.4f} ms (per call {g_call:.4f})")
        out[label] = {"fused_residual_runs": {"ms": s_ms, "call_ms": s_call,
                                              "launches": launches["fused_residual_runs"]},
                      "fused_grad_runs": {"ms": g_ms, "call_ms": g_call,
                                          "launches": launches["fused_grad_runs"]}}
    rows["lm_step_s"] = _lm_step_s(spec, batch, run_slice(ens.params, 1), scales[1])
    rows["pretrain_step_ms"] = _pretrain_step_ms(spec, batch)
    return out, rows


def _pretrain_step_ms(spec, batch, steps: int = 300):
    """ms per pretraining Adam step at this shape, replayed from a CUDA
    graph and launched op by op, in one call; the params must agree to
    rtol 1e-5."""
    import torch
    from gpe_tpu_torch.models.mlp import init_mlp, mlp_apply
    from gpe_tpu_torch.train.pretrain import AdamSteps

    params = init_mlp(spec.layers, "xavier_uniform",
                      generator=torch.Generator().manual_seed(7), device=batch["x"].device)
    out, got = {}, {}
    for graph in (True, False):
        leaves = [t.clone().requires_grad_(True) for pair in params for t in pair]
        pairs = tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))
        mse = lambda: torch.mean((mlp_apply(pairs, batch["x"], spec.activation)
                                  - batch["base_val"]) ** 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        AdamSteps(mse, leaves, 1e-3, graph).run(steps)
        torch.cuda.synchronize()
        out["graph" if graph else "eager"] = 1e3 * (time.perf_counter() - t0) / steps
        got[graph] = torch.cat([t.detach().reshape(-1) for t in leaves])
    rel = float(((got[True] - got[False]).abs() / got[False].abs().clamp_min(1e-6)).max())
    log(f"pretrain Adam step: graphed {out['graph']:.4f} ms, op by op {out['eager']:.4f} "
        f"ms; params max rel {rel:.2e}")
    if not rel <= 1e-5:
        raise AssertionError(f"the graphed Adam steps left the op-by-op ones: {rel:.3e}")
    return out


def _lm_step_s(spec, batch, params, scale, steps: int = 5):
    """Seconds per LM step (80 CG iterations at most) at γ = 20 from trained
    params, each CG matvec replayed from a CUDA graph and launched op by op,
    in one call; the two loss histories must agree to rtol 1e-6."""
    import numpy as np
    import torch
    from gpe_tpu_torch.train.gauss_newton import make_gpe_residual_fn, make_lm_solver

    out, hist = {}, {}
    for graph in (True, False):
        lm = make_lm_solver(make_gpe_residual_fn(spec), params, steps=steps,
                            cg_iters=80, graph=graph)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist[graph] = lm(params, batch, 20.0, scale).loss_history
        torch.cuda.synchronize()
        out["graph" if graph else "eager"] = (time.perf_counter() - t0) / steps
    rel = float(np.max(np.abs(hist[True] / hist[False] - 1.0)))
    log(f"LM step (γ=20, ≤ 80 CG matvecs): graphed {out['graph']:.4f} s, op by op "
        f"{out['eager']:.4f} s; loss histories max rel {rel:.2e}")
    if not rel <= 1e-6:
        raise AssertionError(f"the graphed LM left the op-by-op one: {rel:.3e}")
    return out


def phase_compare_configs(dev):
    """(b) The runner's compare branch on its three configs, 300 epochs,
    into a temporary --out (each seed still pretrains 2000 steps, as the
    JAX runner does): `multirun_box_mode0` |μ_median − π²| < 1e-3 for
    pl_pinn and no launch (hard BC); `multirun_harmonic_mode0` K3 grads
    once per step, 300 per method, K3 sums once per method; and
    `compare_harmonic_mode0` K2 once per step for both methods, K1 once per
    fit. Returns each config's launches and seconds."""
    import tempfile

    from gpe_tpu_torch.experiments import run

    launches, seconds = {}, {}
    with tempfile.TemporaryDirectory() as out:
        for name in ("multirun_box_mode0", "multirun_harmonic_mode0",
                     "compare_harmonic_mode0"):
            t0 = time.perf_counter()
            rc = run.main([name, "--train", "--epochs", "300", "--out", out])
            seconds[name] = time.perf_counter() - t0
            with open(os.path.join(out, name, "summary.json")) as f:
                rec = json.load(f)
            counts = rec["launches"]
            log(f"compare branch {name}: rc {rc}, {seconds[name]:.2f} s; record "
                f"{json.dumps(rec)}")
            if rc != 0:
                raise AssertionError(f"{name}: rc {rc}")
            if name == "compare_harmonic_mode0":
                launches[name] = counts
                want = {"fused_residual": 2, "fused_grad": 600, "fused_residual_runs": 0,
                        "fused_grad_runs": 0}
                if counts != want or not all(math.isfinite(rec[m]["mu"])
                                             for m in ("pl_pinn", "vanilla")):
                    raise AssertionError(f"{name}: launches {counts}, want {want}; {rec}")
                continue
            launches[name] = {k: sum(c[k] for c in counts.values())
                              for k in counts["pl_pinn"]}
            if name == "multirun_box_mode0":
                err = abs(rec["pl_pinn"]["mu_median"] - math.pi ** 2)
                log(f"  multirun_box_mode0: |μ_median − π²| = {err:.3e}")
                if not err < 1e-3 or any(launches[name].values()):
                    raise AssertionError(f"{name}: err {err}, launches {counts}")
            else:
                for m, c in counts.items():
                    if c != {"fused_residual": 0, "fused_grad": 0,
                             "fused_residual_runs": 1, "fused_grad_runs": 300}:
                        raise AssertionError(f"{name} {m}: launches {c}")
    return launches, seconds


def phase_run_family(dev):
    """(c) `paper_tables.run_family("p3_harmonic")` cut to mode 0, 300
    epochs and Δγ = 20 (the ramp is the six checkpoints), into a temporary
    directory: the oracle equal to the committed table's mu_ref (atol
    1e-14), PL-PINN's μ(0) within 1e-3 of 1, every method's row at all six
    γ; wall time and launches per method printed."""
    import csv
    import tempfile

    from gpe_tpu_torch.experiments import paper_tables

    with open(ORACLE_CSV, newline="") as f:
        ref = {float(r["Gamma"]): float(r["mu_ref"]) for r in csv.DictReader(f)
               if int(r["Mode"]) == 0}
    with tempfile.TemporaryDirectory() as out:
        summary = paper_tables.run_family("p3_harmonic", out, epochs=300, ramp_step=20.0,
                                          modes_filter=(0,), verbose=True, device=dev)
        with open(os.path.join(out, "raw_comparison_results.csv"), newline="") as f:
            raw = list(csv.DictReader(f))
    log(f"run_family p3_harmonic mode 0: wall {summary['wall_s']} s; seconds "
        f"{json.dumps(summary['seconds'])}; launches {json.dumps(summary['launches'])}")
    gammas = sorted(ref)
    worst = max(abs(float(r["mu_ref"]) - ref[float(r["Gamma"])]) for r in raw)
    rows = {m: sorted(float(r["Gamma"]) for r in raw if r["Method"] == m)
            for m in paper_tables.METHOD_ORDER}
    pl0 = [float(r["mu"]) for r in raw if r["Method"] == "PL-PINN"
           and float(r["Gamma"]) == 0.0][0]
    log(f"  oracle vs the committed mu_ref: max |Δ| {worst:.3e}; PL-PINN μ(0) "
        f"{pl0:.7f}, |μ(0) − 1| {abs(pl0 - 1.0):.3e}")
    for r in raw:
        log(f"  {r['Method']:>20s} γ={float(r['Gamma']):5.1f}: μ {float(r['mu']):.7f} "
            f"err {float(r['Abs Error']):.3e}")
    if not worst <= 1e-14:
        raise AssertionError(f"the oracle is {worst:.3e} off the committed mu_ref")
    if not abs(pl0 - 1.0) < 1e-3:
        raise AssertionError(f"PL-PINN μ(0) = {pl0} not within 1e-3 of 1")
    if any(g != gammas for g in rows.values()):
        raise AssertionError(f"a method lacks a checkpoint row: {rows}")
    return summary


# phase 7: the continuation and excited-state trainers. The sweep's rungs are
# cut to SWEEP_EPOCHS (300) of 2001 epochs; at β = 1 the pretrained base is
# the exact state, so |μ(1) − |a₀|| above SWEEP_ATOL means a broken path.
# The routes (K2 and autograd) start from the same pretrained params. Their
# μ after SWEEP_EPOCHS: at β = 1 (converged) within ROUTES_BETA1_RTOL, past
# it (unconverged, chaotic) within ROUTES_RTOL. The readings behind both
# (experiments/sweep_controls.py; NVIDIA H100 80GB HBM3, 700 W): routes
# that differ from the card's autograd route in f32 rounding alone (the
# exact K2 step, either route on reordered points, autograd on a CPU, the
# K2 route itself) part by ≤3.5e-6 at β = 1 and ≤1.6e-2 past it; the
# relaxed step with stale cotangents (sweep_controls.FAULTS) by 3.1e-5 and
# 9.7e-2. Then ROUTES_STEPS steps of every rung from the same params:
# the exact K2 step against autograd at ROUTES_EXACT_RTOL (the same
# gradient to f32 round-off; reads ≤4.8e-6), the default relaxed one
# (extrapolated cotangents; reads ≤1.2e-4) at ROUTES_RELAXED_RTOL, and
# each planted fault of sweep_controls.FAULTS (stale cotangents: 2.6e-3,
# the output bias's gradient dropped: 4.0e-3) must leave that bound.
SWEEP_ATOL = 1e-2
ROUTES_BETA1_RTOL, ROUTES_RTOL = 1e-5, 3e-2
ROUTES_EXACT_RTOL, ROUTES_RELAXED_RTOL = 1e-4, 1e-3
EXACT_BASE_ATOL = 1e-2   # μ where a config's pretrained base is exact


def _fused_loss_floor(spec, params, batch, scale):
    """The plain loss on `params` (autograd's value), and the fused loss
    built by `sums_to_loss` from K1's sums and from their plain version."""
    import torch
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.train.problem import make_loss_fn

    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    n = batch["x"].shape[0]
    with torch.no_grad():
        total, aux = make_loss_fn(spec)(params, batch, 0.0, scale)
        bc = spec.bc_weight * float(aux["boundary"])
        out = {"autograd": {"total": float(total), "pde": float(aux["pde"]),
                            "mu": float(aux["mu"])}}
        for label, fn in (("k1", k1.collocation_sums),
                          ("plain", k1.collocation_sums_plain)):
            sums = fn(params, batch["x"], batch["V"], batch["w"], 0.0, scale,
                      batch["base_val"], batch["base_lap"], **kw)
            mu, pde, norm, _ = k1.sums_to_loss(sums, n, spec.norm_weight)
            out[label] = {"total": float(pde) + bc + spec.norm_weight * float(norm),
                          "pde": float(pde), "mu": float(mu)}
    return out


def phase_beta_sweep(dev):
    """(a) The runner's beta_sweep branch on `vary_beta_gravity_well` at full
    width (4,000 points, [1,64,64,64,1]), all six β, SWEEP_EPOCHS a rung,
    2000 pretrain steps, once on the K2 route (the default relaxed step)
    and once on the autograd route (GPE_TPU_TORCH_NO_FUSED=1): K1 once per
    rung and K2 once per step on the first, neither on the second; each μ
    against the exact β^(2/3)·|a₀|, |μ(1) − |a₀|| ≤ SWEEP_ATOL on both,
    the routes' μ within ROUTES_BETA1_RTOL at β = 1 and ROUTES_RTOL past
    it; at every β past the first, ROUTES_STEPS steps from the same params
    by the exact, the relaxed and the planted-fault K2 steps against
    autograd (`sweep_controls.route_steps`). Then on the K2 route's
    params: the fused loss against autograd's at β = 1 and β = 100, and at
    β = 100 K1 and K2 against their plain versions."""
    import tempfile

    from gpe_tpu_torch.experiments import run, sweep_controls, trainer_oracles
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.experiments.sweep_controls import ROUTES_STEPS, SWEEP_EPOCHS
    from gpe_tpu_torch.io import load_bundle
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import params_from_numpy
    from gpe_tpu_torch.train.beta_sweep import beta_scaled
    from gpe_tpu_torch.train.problem import make_batch

    name = "vary_beta_gravity_well"
    cfg = EXPERIMENTS[name]
    betas = sorted(cfg.beta_values)
    bundles, rows, launches = {}, {}, {}
    with tempfile.TemporaryDirectory() as out:
        for route in ("k2", "autograd"):
            k1.collocation_sums.launches = 0
            k2.collocation_grads.launches = 0
            if route == "autograd":
                os.environ["GPE_TPU_TORCH_NO_FUSED"] = "1"
            try:
                rc = run.main([name, "--train", "--epochs", str(SWEEP_EPOCHS), "--out",
                               os.path.join(out, route)])
            finally:
                os.environ.pop("GPE_TPU_TORCH_NO_FUSED", None)
            launches[route] = {"fused_residual": k1.collocation_sums.launches,
                               "fused_grad": k2.collocation_grads.launches}
            with open(os.path.join(out, route, name, "summary.json")) as f:
                rec = json.load(f)
            bundles[route] = load_bundle(os.path.join(out, route, name, "bundle.pkl"))
            fit_s = rec["seconds"]["fit"]["0"]
            table = dict(bundles[route]["mu_table"][0])
            rows[route] = {
                "mu": table, "epochs": bundles[route]["epochs_history"][0],
                "oracle_err": {b: abs(table[b] - trainer_oracles.gravity_well_mu(b))
                               for b in betas},
                "pretrain_s": rec["seconds"]["pretrain"]["0"],
                "ms_per_step": {b: 1e3 * fit_s[str(b)] / SWEEP_EPOCHS for b in betas},
                "wall_s": rec["wall_s"], "launches": launches[route]}
            log(f"beta_sweep {route}: rc {rc}, wall {rec['wall_s']} s, pretrain "
                f"{rows[route]['pretrain_s']:.2f} s, launches {launches[route]}")
            for b in betas:
                log(f"  β={b:5.1f}: μ {table[b]:.7f}, exact "
                    f"{trainer_oracles.gravity_well_mu(b):.7f}, |Δ| "
                    f"{rows[route]['oracle_err'][b]:.3e}, epochs "
                    f"{rows[route]['epochs'][b]}, {rows[route]['ms_per_step'][b]:.4f} "
                    "ms/step")
            if rc != 0 or not all(math.isfinite(v) for v in table.values()):
                raise AssertionError(f"beta_sweep {route}: rc {rc}, μ {table}")
            if not rows[route]["oracle_err"][1.0] <= SWEEP_ATOL:
                raise AssertionError(f"beta_sweep {route}: μ(β=1) {table[1.0]} off |a₀|")
    want = {"k2": {"fused_residual": len(betas), "fused_grad": len(betas) * SWEEP_EPOCHS},
            "autograd": {"fused_residual": 0, "fused_grad": 0}}
    if launches != want:
        raise AssertionError(f"beta_sweep launches {launches}, want {want}")
    rel = sweep_controls.mu_gaps(rows["k2"]["mu"], rows["autograd"]["mu"])
    log(f"  K2 route vs autograd route after {SWEEP_EPOCHS} steps a rung, μ relative "
        f"per β (bounds {ROUTES_BETA1_RTOL:g} at β = 1, {ROUTES_RTOL:g} past it): "
        + ", ".join(f"{b:g}: {v:.2e}" for b, v in rel.items()))
    if not (rel[1.0] <= ROUTES_BETA1_RTOL
            and max(v for b, v in rel.items() if b != 1.0) <= ROUTES_RTOL):
        raise AssertionError(f"the K2 route leaves the autograd route: {rel}")
    steps = sweep_controls.route_steps(bundles["k2"]["params_by_mode"][0],
                                       bundles["k2"]["constant_history"][0], dev,
                                       routes=("exact", "relaxed", *sweep_controls.FAULTS))
    for b, g in steps.items():
        log(f"  β={b:g}: {ROUTES_STEPS} steps from the rung before's params, against "
            "autograd: " + ", ".join(f"{route} {v:.2e}" for route, v in g.items()))
    worst = {route: max(g[route] for g in steps.values()) for route in steps[betas[-1]]}
    faults = {f: worst[f] for f in sweep_controls.FAULTS}
    if not (worst["exact"] <= ROUTES_EXACT_RTOL and worst["relaxed"] <= ROUTES_RELAXED_RTOL
            and min(faults.values()) > ROUTES_RELAXED_RTOL):
        raise AssertionError(f"over {ROUTES_STEPS} steps the K2 routes against autograd "
                             f"(exact ≤ {ROUTES_EXACT_RTOL:g}, relaxed ≤ "
                             f"{ROUTES_RELAXED_RTOL:g}, each planted fault above it): "
                             f"{worst}")

    spec = cfg.spec
    unit = make_batch(spec, 0, device=dev)
    scale = cfg.perturb_const / bundles["k2"]["constant_history"][0]
    floor = {}
    for b in (1.0, 100.0):
        batch = beta_scaled(unit, b)
        params = params_from_numpy(bundles["k2"]["params_by_mode"][0][b], device=dev)
        f = floor[b] = _fused_loss_floor(spec, params, batch, scale)
        log(f"  fused loss at β={b:g}: autograd {f['autograd']['total']:.6e} (pde "
            f"{f['autograd']['pde']:.6e}); from K1's sums − autograd "
            f"{f['k1']['total'] - f['autograd']['total']:.3e} (pde "
            f"{f['k1']['pde'] - f['autograd']['pde']:.3e}); from the plain sums − "
            f"autograd {f['plain']['total'] - f['autograd']['total']:.3e}")
    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    args = (params, batch["x"], batch["V"], batch["w"], 0.0, scale)
    base = (batch["base_val"], batch["base_lap"])
    sums = k1.collocation_sums(*args, *base, **kw)
    want_s = k1.collocation_sums_plain(*args, *base, **kw)
    s_rel = float(((sums - want_s).abs() / want_s.abs()).max())
    cots = k1.sums_to_loss(sums, batch["x"].shape[0], spec.norm_weight)[3]
    got, s_got = k2.collocation_grads(*args, cots, *base, **kw)
    ab, norm = _grad_err(got, k2.collocation_grads_plain(*args, cots, *base, **kw)[0])
    k2_rel = float(((s_got - sums).abs() / sums.abs()).max())
    log(f"  β=100, the K2 route's params: K1 vs plain max rel {s_rel:.2e}; K2 grads "
        f"vs plain max|Δ| {ab:.3e}, normalised {norm:.2e}; K2's sums vs K1 "
        f"{k2_rel:.2e}")
    if s_rel > K1_TOL or norm > K2_TOL or k2_rel > K1_TOL or not math.isfinite(ab):
        raise AssertionError(f"K1/K2 at β=100: sums {s_rel:.3e}, grads {norm:.3e}, "
                             f"K2's sums {k2_rel:.3e}")
    return launches["k2"], {"routes": rows, "routes_mu_rel": rel, "route_steps": steps,
                            "loss_floor": floor,
                            "beta100_kernels": {"k1_rel": s_rel, "k2_grad_norm": norm,
                                                "k2_sums_rel": k2_rel}}


# the other configs of the slice at full width, cut in depth: the runner's
# extra arguments, where the record's μ are, and the exact μ of the first
# rung where the pretrained base is that rung's exact state
TRAINER_RUNS = {
    "vary_beta_harmonic": (["--betas", "0", "0.5", "1", "--epochs", "100", "--pretrain",
                            "300"], "bundle", (math.pi / 5) ** 2),
    "vary_beta_box_gaussian": (["--betas", "0", "0.5", "1", "--epochs", "100",
                                "--pretrain", "300"], "bundle", math.pi ** 2),
    "two_stage_beta_gamma": (["--betas", "1", "1.5", "2", "--gammas", "0", "1",
                              "--epochs", "100"], "mu_beta", 1.0),
    "p_ramp_harmonic": (["--epochs", "100", "--pretrain", "300"], "mu_table", None),
    "deflation_harmonic": (["--epochs", "100", "--lm-steps", "5"], "mu_table", None),
    "deflation_2d": (["--epochs", "100", "--lm-steps", "3"], "mu_table", None),
    "gpe2d_relobralo": (["--epochs", "100"], "mu", None),
}


def phase_trainer_configs(dev):
    """(b) Every other config of the slice through the runner at full width
    and point count, cut in depth (TRAINER_RUNS), into a temporary --out:
    rc 0, finite μ, no K1 or K2 launch (the hard-BC sweeps, the (β, γ)
    pair, the p ramp, deflation and ReLoBRaLo train by autograd, as in the
    JAX package), and μ of the first rung within EXACT_BASE_ATOL of the
    exact value where the pretrained base is exact (the box sweeps at β =
    0, the two-stage run at β = 1). Returns the launches summed over the
    configs and each config's seconds."""
    import tempfile

    from gpe_tpu_torch.experiments import run
    from gpe_tpu_torch.io import load_bundle
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1

    total = {"fused_residual": 0, "fused_grad": 0}
    seconds = {}
    with tempfile.TemporaryDirectory() as out:
        for name, (extra, where, exact) in TRAINER_RUNS.items():
            k1.collocation_sums.launches = 0
            k2.collocation_grads.launches = 0
            t0 = time.perf_counter()
            rc = run.main([name, "--train", "--out", out] + extra)
            seconds[name] = time.perf_counter() - t0
            counts = {"fused_residual": k1.collocation_sums.launches,
                      "fused_grad": k2.collocation_grads.launches}
            for k in total:
                total[k] += counts[k]
            with open(os.path.join(out, name, "summary.json")) as f:
                rec = json.load(f)
            log(f"{name}: rc {rc}, {seconds[name]:.2f} s, launches {counts}; record "
                f"{json.dumps({k: v for k, v in rec.items() if k != 'seconds'})}")
            if where == "bundle":
                table = load_bundle(os.path.join(out, name, "bundle.pkl"))["mu_table"][0]
                mus = [m for _, m in table]
            elif where == "mu":
                mus = [rec["mu"], rec["loss"]]
            else:
                mus = [m for _, m in rec[where]]
            if rc != 0 or any(counts.values()) or not all(math.isfinite(m) for m in mus):
                raise AssertionError(f"{name}: rc {rc}, launches {counts}, μ {mus}")
            if exact is not None:
                err = abs(mus[0] - exact)
                log(f"  {name}: |μ(first rung) − {exact:.7f}| = {err:.3e}")
                if not err <= EXACT_BASE_ATOL:
                    raise AssertionError(f"{name}: μ {mus[0]} off the exact {exact}")
    return total, seconds


# phase 8: collocation-sharded training over torch.distributed, two gloo
# ranks on the one card (NCCL refuses two ranks on one card). The
# psum-aware K2 against the unsharded K2 at tests/test_fused_sharded.py's
# same-kernel bounds (total rtol 1e-6, gradients normalised 1e-5, relaxed
# state 1e-5), the relaxed step's exact K1 correctors (MESH_CORRECTORS)
# included. All from random params, where the loss is large: near a
# converged net the loss is a small difference of large sums, and any
# change of summation order (the unsharded vag on reordered points too)
# moves the total by 3e-6 and the gradients by 5e-5, above those bounds
# (experiments/mesh_controls.py, "conditioning").
# The corrector walk takes MESH_CORRECTOR_LR, small enough that four steps
# stay finite from that start (1e-3 overflows by the third).
#
# The sharded fit against the unsharded one at its fit bound (1e-4) over
# its first MESH_FIT_GATE_STEPS steps: at this shape any change of
# summation order (the unsharded fit on its points reordered too) moves the
# loss history by more than 1e-4 after 12–75 steps and the best loss of 200
# steps by 0.07–42% (NVIDIA H100 80GB HBM3, 700 W), so the 200-step best
# loss is printed beside the reordered fit's, not held. Its μ_best is held
# at MESH_FIT_MU_RTOL: sound runs, sharded or reordered, left it
# 9.4e-6–4.9e-4 from the unsharded fit over three starts and both step
# modes, 2.2e-5 (sharded) and 9.5e-5 (reordered) at this start, while the
# relaxed cotangents built with the local point count moved it by 2.7e-3
# (experiments/mesh_controls.py, same card; PERF.md §6).
#
# The sharded ensemble against the unsharded ensembles of each rank's runs
# at 1e-5, and against the unsharded ensemble of all runs in its first step
# only: the batched products of the step's plain parts (the boundary term,
# the fresh S₂, S₃) round by the run count, and a random start amplifies it
# (73% in the loss after 100 steps on that card).
MESH_RANKS = 2
PSUM_TOTAL_RTOL, PSUM_GRAD_TOL, PSUM_STATE_RTOL = 1e-6, 1e-5, 1e-5
MESH_FIT_RTOL, MESH_ENS_RTOL = 1e-4, 1e-5
MESH_FIT_STEPS, MESH_FIT_GATE_STEPS, MESH_ENS_STEPS = 200, 10, 100
MESH_FIT_MU_RTOL = 1e-3
MESH_CORRECTORS = dict(refresh_every=2, exact_until=2)   # K1 at steps 1 and 2
MESH_CORRECTOR_LR = 1e-6    # the walk's step: the loss 406 → 170 in 4 steps
MESH_RUNNER = ["--epochs", "300", "--gammas", "0", "1", "2", "--pretrain", "300"]


def _flat_err(got, want, layers):
    """(max abs error, max over leaves of max|Δ| / max|want|) of flat grads."""
    import numpy as np
    sizes = [n for k, m in zip(layers[:-1], layers[1:]) for n in (k * m, m)]
    cuts = np.cumsum(sizes)[:-1]
    worst_abs, worst_norm = 0.0, 0.0
    for g, w in zip(np.split(got, cuts), np.split(want, cuts)):
        d = float(np.abs(g - w).max())
        worst_abs = max(worst_abs, d)
        worst_norm = max(worst_norm, d / (float(np.abs(w).max()) + 1e-30))
    return worst_abs, worst_norm


def phase_mesh(dev):
    """(a) K2's psum-aware mode at the main shape (50,176 points,
    [2,128,128,128,1], γ 5, s 0.05) over MESH_RANKS gloo ranks on this
    card: two steps of the exact vag and of the default relaxed one (fresh
    values, extrapolation), and four of the relaxed one with its exact K1
    correctors (MESH_CORRECTORS, walked at MESH_CORRECTOR_LR), against the
    unsharded vags on the same card; K2 once a step on each rank, K1 once
    a step (exact), once a fit (relaxed) or once a fit and once a
    corrector. (b) `fit(mesh=, value_and_grad_fn=
    make_fused_value_and_grad(spec, n_shards=2))`, MESH_FIT_STEPS Adam
    steps (clip 1.0) at γ 5 from the net pretrained 300 steps to the base
    (a ramp's start), against the unsharded fused fit over the first
    MESH_FIT_GATE_STEPS steps and in its μ_best after MESH_FIT_STEPS
    (MESH_FIT_MU_RTOL), printed beside the unsharded fit on reordered
    points; ms a step of both and of the step's all-reduces. (c)
    `fit_ensemble(mesh=)` of six runs at `harmonic_paper`'s shape
    (runs_shape's params, per-run γ and scale, the mode-0 base) on K3,
    three runs a rank, against the unsharded ensembles of each rank's three
    runs and, in its first step, against the unsharded six-run ensemble.
    (d) the runner on `plpinn_sharded_dp` at cut depth (MESH_RUNNER) on a
    world-size-1 NCCL mesh in this process, |μ(0) − 1| ≤ CROSS_ATOL.
    Returns the `fused_grad_psum` kernel row (K2 at the local shard against
    its plain version: device ms, plain and nested-autograd ms, bound) and
    the phase's numbers."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from gpe_tpu_torch.bench import nested_autograd_sums
    from gpe_tpu_torch.experiments import run
    from gpe_tpu_torch.experiments.mesh_check import run_cases, walk
    from gpe_tpu_torch.io import load_bundle
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import mlp_apply
    from gpe_tpu_torch.train.loop import fit, fit_ensemble
    from gpe_tpu_torch.train.optimizers import make_optimizer
    from gpe_tpu_torch.train.pretrain import pretrain_to_base
    from gpe_tpu_torch.train.problem import (base_triple, make_batch,
                                             make_fused_value_and_grad, make_loss_fn)

    cfg, spec, batch, params = main_shape(dev)
    np_params = [(w.cpu().numpy(), b.cpu().numpy()) for w, b in params]
    gamma, scale = 5.0, 0.05
    pre, _ = pretrain_to_base(params, batch["x"], base_triple(spec, 0, batch["x"]).value,
                              spec.activation, epochs=300, lr=1e-3)
    with torch.no_grad():
        pre_scale = cfg.perturb_const / float(torch.max(mlp_apply(pre, batch["x"],
                                                                  spec.activation)))
    np_pre = [(w.cpu().numpy(), b.cpu().numpy()) for w, b in pre]
    _, rspec, _, rparams, rgammas, rscales = runs_shape(dev)
    rbatch = make_batch(rspec, 0, device=dev)
    np_rparams = [(w.cpu().numpy(), b.cpu().numpy()) for w, b in rparams]
    cases = [
        ("exact", "vag", dict(spec=spec, params=np_params, gamma=gamma, scale=scale,
                              relaxed=False, steps=2)),
        ("relaxed", "vag", dict(spec=spec, params=np_params, gamma=gamma, scale=scale,
                                relaxed=None, steps=2)),
        ("corrector", "vag", dict(spec=spec, params=np_params, gamma=gamma, scale=scale,
                                  relaxed=None, steps=4, lr=MESH_CORRECTOR_LR,
                                  **MESH_CORRECTORS)),
        ("fit", "fit", dict(spec=spec, params=np_pre, gamma=gamma, scale=pre_scale,
                            epochs=MESH_FIT_STEPS, check_every=MESH_FIT_STEPS,
                            fused=True, lr=cfg.lr, reps=50)),
        ("ens", "ensemble", dict(spec=rspec, params_b=np_rparams,
                                 gamma=rgammas.cpu().numpy(),
                                 scales=rscales.cpu().numpy(), epochs=MESH_ENS_STEPS,
                                 check_every=MESH_ENS_STEPS, fused=True, relaxed=None)),
    ]
    t0 = time.perf_counter()
    ranks = run_cases(cases, nprocs=MESH_RANKS, backend="gloo")
    spawn_s = time.perf_counter() - t0
    log(f"mesh: {MESH_RANKS} gloo ranks on {torch.cuda.get_device_name(0)}, "
        f"{spawn_s:.1f} s for the spawn and cases (a)–(c)")
    for key in ranks[0]:
        if not key.endswith("/s") and not key.endswith("_ms") \
                and not np.array_equal(ranks[0][key], ranks[1][key]):
            raise AssertionError(f"mesh: {key} differs across the ranks")

    # (a) the psum-aware vag against the unsharded one
    worst_abs = 0.0
    for label, relaxed, kw, steps, want_k1, lr in (
            ("exact", False, {}, 2, 2, 1e-3),
            ("relaxed", None, {}, 2, 1, 1e-3),
            ("corrector", None, MESH_CORRECTORS, 4, 3, MESH_CORRECTOR_LR)):
        want = walk(make_fused_value_and_grad(spec, device=dev, relaxed=relaxed, **kw),
                    params, batch, gamma, scale, steps=steps, lr=lr)
        r = ranks[0]
        t_rel = float(np.abs(r[f"{label}/total"] / want["total"] - 1).max())
        g_abs, g_norm = 0.0, 0.0
        for got, w in zip(r[f"{label}/grads"], want["grads"]):
            a, nrm = _flat_err(got, w, spec.layers)
            g_abs, g_norm = max(g_abs, a), max(g_norm, nrm)
        s_rel = (float(np.abs(r[f"{label}/state"] / want["state"] - 1).max())
                 if "state" in want else 0.0)
        k1_n = [int(x[f"{label}/launches_fused_residual"]) for x in ranks]
        k2_n = [int(x[f"{label}/launches_fused_grad"]) for x in ranks]
        log(f"mesh (a) {label} vag, {steps} steps: total max rel {t_rel:.2e}, grads max|Δ| "
            f"{g_abs:.3e} normalised {g_norm:.2e}, state max rel {s_rel:.2e}; "
            f"launches per rank K1 {k1_n} K2 {k2_n}")
        if not np.isfinite(want["total"]).all() or not (
                t_rel <= PSUM_TOTAL_RTOL and g_norm <= PSUM_GRAD_TOL
                and s_rel <= PSUM_STATE_RTOL) or k2_n != [steps] * 2 \
                or k1_n != [want_k1] * 2:
            raise AssertionError(f"mesh (a) {label}: total {t_rel:.3e}, grads "
                                 f"{g_norm:.3e}, state {s_rel:.3e}, K1 {k1_n}, K2 {k2_n}")
        worst_abs = max(worst_abs, g_abs)

    # (b) the sharded fused fit against the unsharded one
    loss_fn = make_loss_fn(spec)
    vag = make_fused_value_and_grad(spec, device=dev)

    def unsharded(b):
        return fit(loss_fn, make_optimizer("adam", cfg.lr, clip_norm=1.0), pre, b,
                   gamma, pre_scale, epochs=MESH_FIT_STEPS, tol=0.0, patience=10 ** 9,
                   check_every=MESH_FIT_STEPS, value_and_grad_fn=vag)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = unsharded(batch)
    torch.cuda.synchronize()
    ref_ms = 1e3 * (time.perf_counter() - t0) / MESH_FIT_STEPS
    n = batch["x"].shape[0]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1)).to(dev)
    reordered = unsharded({k: v[perm].contiguous() if v.shape[:1] == (n,) else v
                           for k, v in batch.items()})
    r = ranks[0]
    k = MESH_FIT_GATE_STEPS
    head = max(float(np.abs(r["fit/loss_history"][:k] / ref.loss_history[:k] - 1).max()),
               float(np.abs(r["fit/mu_history"][:k] / ref.mu_history[:k] - 1).max()))
    def end(best_loss, mu_best):
        return {"best_loss": abs(best_loss / ref.best_loss - 1),
                "mu_best": abs(mu_best / ref.mu_best - 1)}

    end_rel = {"sharded": end(float(r["fit/best_loss"]), float(r["fit/mu_best"])),
               "reordered": end(reordered.best_loss, reordered.mu_best)}
    fit_k2 = [int(x["fit/launches_fused_grad"]) for x in ranks]
    fit_k1 = [int(x["fit/launches_fused_residual"]) for x in ranks]
    fit_ms = [1e3 * float(x["fit/s"]) for x in ranks]
    ar_ms = [float(x["fit/allreduce_grads_ms"]) + float(x["fit/allreduce_sums_ms"])
             for x in ranks]
    log(f"mesh (b) fit(mesh=), {MESH_FIT_STEPS} relaxed fused steps from the pretrained "
        f"net: the first {k} steps' loss and μ max rel {head:.2e}; after "
        f"{MESH_FIT_STEPS}, best_loss and μ_best rel to the unsharded fit "
        f"{end_rel['sharded']}, of the unsharded fit on reordered points "
        f"{end_rel['reordered']}; ms/step sharded {[round(m, 4) for m in fit_ms]} vs "
        f"unsharded {ref_ms:.4f}; all-reduces {[round(m, 4) for m in ar_ms]} ms a step; "
        f"launches per rank K1 {fit_k1} K2 {fit_k2}")
    if not head <= MESH_FIT_RTOL \
            or not end_rel["sharded"]["mu_best"] <= MESH_FIT_MU_RTOL or fit_k2 != [MESH_FIT_STEPS] * 2 or fit_k1 != [1, 1] \
            or not math.isfinite(float(r["fit/best_loss"])):
        raise AssertionError(f"mesh (b): {head:.3e}, {end_rel['sharded']}, K1 {fit_k1}, "
                             f"K2 {fit_k2}")
    fit_rel = {"first_steps": head, **end_rel}

    # (c) the sharded ensemble against the unsharded ensembles of each rank's
    # runs, and against the unsharded ensemble of all six runs
    rloss = make_loss_fn(rspec)
    rvag = make_fused_value_and_grad(rspec, device=dev)

    def ensemble(a, b):
        return fit_ensemble(rloss, make_optimizer("adam", cfg.lr, clip_norm=1.0),
                            tuple((w[a:b], c[a:b]) for w, c in rparams), rbatch,
                            rgammas[a:b], rscales[a:b], epochs=MESH_ENS_STEPS, tol=0.0,
                            patience=10 ** 9, check_every=MESH_ENS_STEPS,
                            value_and_grad_fn=rvag)

    R = rscales.shape[0]
    per = R // MESH_RANKS
    blocks = [ensemble(i * per, (i + 1) * per) for i in range(MESH_RANKS)]
    whole = ensemble(0, R)
    keys = ("loss_history", "mu_history", "mu_best")
    ens_rel = {k: float(np.abs(r[f"ens/{k}"] / np.concatenate(
        [getattr(b, k) for b in blocks]) - 1).max()) for k in keys}
    whole_rel = {k: float(np.abs(r[f"ens/{k}"] / getattr(whole, k) - 1).max())
                 for k in keys}
    first = float(np.abs(r["ens/loss_history"][:, 0] / whole.loss_history[:, 0] - 1).max())
    ens_k3 = [int(x["ens/launches_fused_grad_runs"]) for x in ranks]
    ens_k3s = [int(x["ens/launches_fused_residual_runs"]) for x in ranks]
    log(f"mesh (c) fit_ensemble(mesh=), {R} runs, {MESH_ENS_STEPS} steps: max rel to "
        f"the unsharded ensembles of each rank's {per} runs {ens_rel}; to the "
        f"unsharded {R}-run ensemble {whole_rel} (first step's loss {first:.2e}); K3 "
        f"launches per rank: grads {ens_k3}, sums {ens_k3s}; "
        f"{float(r['ens/s']):.2f} s a rank")
    if max(ens_rel.values()) > MESH_ENS_RTOL or first > MESH_ENS_RTOL \
            or ens_k3 != [MESH_ENS_STEPS] * 2 or ens_k3s != [1, 1]:
        raise AssertionError(f"mesh (c): {ens_rel}, first {first:.3e}, K3 {ens_k3}, "
                             f"{ens_k3s}")
    ens_rel = {"rank_blocks": ens_rel, "whole": whole_rel, "whole_first_step": first}

    # (d) the runner on a world-size-1 NCCL mesh
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc = run.main(["plpinn_sharded_dp", "--train", "--out", out] + MESH_RUNNER)
        runner_s = time.perf_counter() - t0
        exp = os.path.join(out, "plpinn_sharded_dp")
        with open(os.path.join(exp, "summary.json")) as f:
            rec = json.load(f)
        mus = dict(load_bundle(os.path.join(exp, "bundle.pkl"))["mu_table"][0])
    dist.destroy_process_group()
    err0 = abs(mus[0.0] - 1.0)
    log(f"mesh (d) run.py plpinn_sharded_dp ({' '.join(MESH_RUNNER)}): rc {rc}, "
        f"{runner_s:.1f} s, μ per γ {mus}, |μ(0) − 1| = {err0:.3e}; record "
        f"{json.dumps(rec)}")
    if rc != 0 or rec.get("mesh_devices") != 1 or not err0 <= CROSS_ATOL \
            or not all(math.isfinite(m) for m in mus.values()):
        raise AssertionError(f"mesh (d): rc {rc}, μ {mus}, record {rec}")

    # the kernel row: K2 at one rank's shard of the main shape
    half = batch["x"].shape[0] // MESH_RANKS
    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    loc = {k: batch[k][:half].contiguous() for k in ("x", "V", "w", "base_val",
                                                     "base_lap")}
    args = (loc["x"], loc["V"], loc["w"])
    base = (loc["base_val"], loc["base_lap"])
    sums = k1.collocation_sums(params, *args, gamma, scale, *base, **kw)
    cots = k1.sums_to_loss(sums, batch["x"].shape[0], spec.norm_weight)[3]
    leaves = [t.detach().requires_grad_(True) for pair in params for t in pair]
    pairs = tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))

    def library():
        s = nested_autograd_sums(pairs, loc, gamma, scale, spec.activation, spec.p,
                                 spec.kinetic, spec.nonlinearity)
        return torch.autograd.grad(torch.sum(cots * s), leaves)

    got, _ = k2.collocation_grads(params, *args, gamma, scale, cots, *base, **kw)
    plain, _ = k2.collocation_grads_plain(params, *args, gamma, scale, cots, *base, **kw)
    torch.cuda.synchronize()
    p_abs, p_norm = _grad_err(got, plain)
    if not p_norm <= K2_TOL:
        raise AssertionError(f"K2 at the local shard: {p_norm:.3e} from its plain version")
    ms, call_ms = kernel_ms(lambda: k2.collocation_grads(params, *args, gamma, scale,
                                                         cots, *base, **kw), 20)
    plain_ms = time_ms(lambda: k2.collocation_grads_plain(
        params, *args, gamma, scale, cots, *base, **kw), 10)
    lib_ms = time_ms(library, 3)
    b_ms, b_by = bound(spec.layers, half, grad=True)
    log(f"K2 at the local shard ({half} points): grads max|Δ| {p_abs:.3e} from its "
        f"plain version, normalised {p_norm:.2e}; kernel {ms:.4f} ms (per call "
        f"{call_ms:.4f}), plain {plain_ms:.4f} ms, nested autograd {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    row = {"name": "fused_grad_psum", "route": "cuda",
           "source": "gpe_tpu_torch/csrc/fused_grad.cu",
           "replaces": "gpe_tpu/pallas/fused_grad.py:460",
           "launches": sum(fit_k2), "launches_per_rank": fit_k2,
           "max_abs_err": p_abs, "max_abs_err_vs_unsharded_k2": worst_abs,
           "ms": ms, "call_ms": call_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib_ms, "local_points": half, "ranks": MESH_RANKS}
    numbers = {"spawn_s": spawn_s, "fit_ms": fit_ms, "unsharded_fit_ms": ref_ms,
               "allreduce_ms": ar_ms, "fit_rel": fit_rel, "ensemble_rel": ens_rel,
               "ensemble_k3_per_rank": ens_k3, "runner_s": runner_s,
               "runner_mu": mus, "runner_mu0_err": err0}
    return row, numbers


# phase 9: the optimizer zoo, the curriculum and the Helmholtz family. They
# train by autograd, as the JAX package does (train_curriculum and
# train_helmholtz call fit without a fused gradient), so no kernel may
# launch. (a) ZOO_STEPS fit steps of every optimizer of make_optimizer (and
# adam with reduce-on-plateau) on different_optimizers_harmonic's problem
# at full width and point count, η = 10 under the curriculum's α schedule,
# on the card and on the CPU from the same params, batch and probes: loss
# histories at ZOO_RTOL; the card's f32 steps timed (ms a step).
# (b) the runner's optimizer sweep cut in depth (ZOO_SWEEP); (c) the three
# Helmholtz configs through the runner, cut (HELMHOLTZ_RUN). (b) and (c) are
# held to rc 0 and finite results alone, so their depth is the script's
# time budget's: 50 and 200 epochs since phase 13 came (150 and 500 before).
# AdaHessian and Sophia divide by Hutchinson's estimate of the Hessian
# diagonal (Sophia also switches, element by element, between m/(γh) and
# its clip where h ≈ 0), and L-BFGS's line search branches on comparisons
# of host numbers: the card's and the CPU's f32 round-off differ, flip
# them, and their f32 histories part by 5.7e-3, 1.9e-2 and 0.13 within 10
# steps (NVIDIA H100 80GB HBM3, 700 W; in float64 3.5e-12, 1.9e-13 and
# 3.1e-7). ZOO_F64 are compared in float64 only, and timed in f32.
ZOO = [(n, {}) for n in ("adam", "adamw", "qhadam", "adahessian", "adabelief", "sophia",
                         "rmsprop", "sgd", "muon", "prodigy", "ranger21", "shampoo",
                         "distributed_shampoo", "lbfgs")] + [("adam", {"plateau": {"patience": 3}})]
ZOO_F64 = ("adahessian", "sophia", "lbfgs")
ZOO_STEPS, ZOO_RTOL, ZOO_ETA = 10, 1e-4, 10.0
ZOO_SWEEP = ["--gammas", "0", "10", "--epochs", "50"]
HELMHOLTZ_RUN = ["--epochs", "200", "--lbfgs-steps", "20", "--lm-steps", "10"]


def _kernel_counters() -> dict:
    """Every kernel's launch counter by the name of its row (the psum-aware
    K2 counts as K2), as (read, reset) pairs."""
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.kernels import rowcat_eval as k4

    fields = {"fused_residual": (k1.collocation_sums, "launches"),
              "fused_residual_bf16": (k1.collocation_sums, "bf16_launches"),
              "fused_grad": (k2.collocation_grads, "launches"),
              "fused_grad_psum": (k2.collocation_grads, "launches"),
              "fused_residual_runs": (k1.collocation_sums_runs, "launches"),
              "fused_grad_runs": (k2.collocation_grads_runs, "launches"),
              "rowcat_eval": (k4.collocation_sums, "launches"),
              "rowcat_eval_bf16": (k4.collocation_sums, "bf16_launches"),
              "fused_grad_bf16": (k2.collocation_grads, "bf16_launches"),
              "fused_grad_runs_bf16": (k2.collocation_grads_runs, "bf16_launches"),
              "fused_residual_runs_bf16": (k1.collocation_sums_runs, "bf16_launches")}
    return {name: (lambda fn=fn, a=a: getattr(fn, a), lambda fn=fn, a=a: setattr(fn, a, 0))
            for name, (fn, a) in fields.items()}


def phase_zoo(dev):
    """Phase 9 (a)–(c); returns the launches of every kernel over the phase
    (all 0) and its numbers."""
    import tempfile

    import numpy as np
    import torch

    from gpe_tpu_torch.experiments import run
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.models.mlp import init_mlp
    from gpe_tpu_torch.train.curriculum import alpha_schedule
    from gpe_tpu_torch.train.loop import fit
    from gpe_tpu_torch.train.optimizers import make_optimizer
    from gpe_tpu_torch.train.problem import make_batch, make_loss_fn

    counters = _kernel_counters()
    for _, reset in counters.values():
        reset()
    cfg = EXPERIMENTS["different_optimizers_harmonic"]
    sched = alpha_schedule()

    def problem(dtype):
        """(loss_fn, the CPU's and the card's params and batch) in `dtype`,
        built on the CPU and copied to the card."""
        spec = dataclasses.replace(cfg.spec, dtype=dtype)
        batch = make_batch(spec, 0, device="cpu")
        params = init_mlp(spec.layers, generator=torch.Generator().manual_seed(0),
                          dtype=dtype, device="cpu")
        return (make_loss_fn(spec), (params, batch),
                (tuple((w.to(dev), b.to(dev)) for w, b in params),
                 {k: v.to(dev) for k, v in batch.items()}))

    def steps(name, kw, loss_fn, p, b, n):
        return fit(loss_fn, make_optimizer(name, cfg.lr, clip_norm=1.0, **kw), p, b,
                   ZOO_ETA, 1.0, epochs=n, tol=0.0, patience=10**9, check_every=n,
                   scale_schedule=sched)

    def timed(name, kw, loss_fn, params, batch):
        """The card's fit and its ms a step (host clock, synchronised),
        after one warm-up step of the optimizer (its first call's set-up)."""
        steps(name, kw, loss_fn, params, batch, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = steps(name, kw, loss_fn, params, batch, ZOO_STEPS)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3 / ZOO_STEPS

    f32, f64 = problem(torch.float32), problem(torch.float64)
    gaps, ms = {}, {}
    for name, kw in ZOO:
        label = name + ("+plateau" if kw else "")
        card, ms[label] = timed(name, kw, f32[0], *f32[2])
        if name in ZOO_F64:
            card = steps(name, kw, f64[0], *f64[2], ZOO_STEPS)
        loss_fn, host = (f64 if name in ZOO_F64 else f32)[:2]
        hist = steps(name, kw, loss_fn, *host, ZOO_STEPS).loss_history
        gaps[label] = float(np.max(np.abs(card.loss_history / hist - 1.0)))
        log(f"zoo {label}: card vs CPU over {ZOO_STEPS} steps in "
            f"{'f64' if name in ZOO_F64 else 'f32'}, worst loss gap {gaps[label]:.3e} "
            f"(loss {hist[0]:.4e} → {hist[-1]:.4e}); {ms[label]:.3f} ms a step on the "
            "card in f32")
    bad = {k: v for k, v in gaps.items() if not v <= ZOO_RTOL}
    if bad:
        raise AssertionError(f"zoo: card against CPU over {ZOO_RTOL:g}: {bad}")

    sweep, helm = {}, {}
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc = run.main(["different_optimizers_harmonic", "--train", "--out", out] + ZOO_SWEEP)
        sweep_s = time.perf_counter() - t0
        with open(os.path.join(out, "different_optimizers_harmonic", "summary.json")) as f:
            recs = json.load(f)
        for rec in recs:
            sweep[rec["optimizer"]] = {"mu_table": rec["mu_table"],
                                       "ms_per_step": rec["ms_per_step"]}
            log(f"sweep {rec['optimizer']}: {rec['ms_per_step']:.3f} ms a step, "
                f"μ {rec['mu_table']}")
        mus = [m for r in sweep.values() for _, m in r["mu_table"]]
        if (rc != 0 or set(sweep) != set(EXPERIMENTS["different_optimizers_harmonic"].optimizers)
                or not all(math.isfinite(m) for m in mus)):
            raise AssertionError(f"optimizer sweep: rc {rc}, records {sweep}")
        for name in ("helmholtz_square", "helmholtz_circle", "helmholtz_inverse_k"):
            t0 = time.perf_counter()
            rc = run.main([name, "--train", "--out", out] + HELMHOLTZ_RUN)
            wall = time.perf_counter() - t0
            with open(os.path.join(out, name, "summary.json")) as f:
                rec = json.load(f)
            helm[name] = {"s": wall, **{k: rec[k] for k in ("k", "test_mae",
                                                             "interior_mse", "k_error",
                                                             "seconds")}}
            log(f"{name}: rc {rc}, {wall:.2f} s, test MAE {rec['test_mae']:.4e}, "
                f"k {rec['k']:.6f} (k_error {rec['k_error']:.3e}), seconds {rec['seconds']}")
            if rc != 0 or not math.isfinite(rec["test_mae"]):
                raise AssertionError(f"{name}: rc {rc}, record {rec}")
    launches = {name: read() for name, (read, _) in counters.items()}
    log(f"phase 9 launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 9 launched kernels: {launches}")
    return launches, {"card_vs_cpu_gap": gaps, "ms_per_step": ms, "sweep": sweep,
                      "sweep_s": sweep_s, "helmholtz": helm}


# ---- phase 10: DeepONet, the spectral-flow flagships, 3D, SNGD ------------
# DeepONet (10a): deeponet_harmonic at full width (64 potentials × 512
# points, 64 sensors, branch [64,64,64,40], trunk [1,64,64,40]) through the
# runner, cut (DON_RUN); the card against the CPU over DON_STEPS fit steps
# from the same params (f32 loss histories at DON_RTOL); the nine held-out
# FDM oracle μ against the CPU's (the oracle runs on the host either way);
# and, after the full DON_PRETRAIN pretraining steps at γ = 0, every
# potential's μ within DON_MU_ATOL of √β. The bound comes from a planted
# fault (the same pretraining on the targets of 1.5·β), which this phase
# runs too and which must break it: on the CPU the true targets gave
# max |μ − √β| 0.065 and the planted ones 0.143 (after 300 steps the
# pretraining gives 1.08, too far from its fixed point for any bound).
DON_RUN = ["--epochs", "300", "--pretrain", "300"]
DON_STEPS, DON_RTOL, DON_PRETRAIN, DON_MU_ATOL = 10, 1e-4, 3000, 0.1
DON_ORACLE_ATOL = 1e-10
# The 2D flagship (10b) at 224², [2,128,128,128,1], cut: 300 Adam + 20
# L-BFGS pretraining steps (FLOW_PRETRAIN), γ ∈ {2, 5}, outer 10, inner
# 80, final 300 + 40, polish 5 (FLOW_CUT), the driver's pipeline on the
# solver (`_flow_rungs`); every L-BFGS phase runs its full count. The
# endgame's μ_grid at γ = 5 is a converged float64 fixed point (tol 1e-13,
# Richardson order 1), so the oracle run from the exact linear ground state
# lands on it to FLOW_GRID_ATOL. Card against CPU: FLOW_PARITY_OUTER outer
# steps of the interleave at FLOW_PARITY_WIDTH, the grid μ at
# FLOW_MU_RTOL and the fit losses at FLOW_FIT_RTOL (f32 Adam trajectories:
# each device's own GEMM rounding).
FLOW_PRETRAIN = dict(epochs=300, lbfgs_steps=20)
FLOW_CUT = dict(outer_steps=10, inner_steps=80, final_inner_steps=300,
                final_lbfgs_steps=40, polish_steps=5)
FLOW_GRID_ATOL = 1e-8
FLOW_PARITY_WIDTH, FLOW_PARITY_OUTER = 32, 3
FLOW_MU_RTOL, FLOW_FIT_RTOL = 1e-5, 1e-3
# The JAX flagships' params (10c) through the port's `report`: μ at γ = 100
# by the JAX package's report arithmetic in f32 on a CPU (matmul precision
# "highest"); tests/test_torch_spectral_flow.py and tests/test_torch_3d.py
# compute them with JAX and hold the port's report to them. The runs' own
# summaries record 5.759739875793457 and 3.7131776809692383, computed on
# the TPU.
FLAGSHIP_MU = {"gpe2d_flagship": 5.759762287139893,
               "gpe3d_ground_state": 3.7132601737976074}
FLAGSHIP_ATOL = 1e-6
# 3D (10d): K1 and K2 at d = 3 on 36³ points, [3,128,128,128,1] (γ 5, s
# 0.01); the 3D PL-PINN path on them (train_plpinn at γ = 0, PLPINN3D_RUN),
# μ(0) within CROSS_ATOL of 1.5; one spectral-flow rung at 36³ with the
# 10b cut (`_flow_rungs`; γ = 5, μ_grid against the oracle at
# FLOW_GRID_ATOL).
PLPINN3D_RUN = dict(epochs=2000, pretrain_epochs=1000)
# SNGD and the Sobolev pretraining (10e), card against CPU: the SNGD μ and
# residual histories (2D, 32², [2,32,32,1], 5 × 20 steps) at SNGD_RTOL in
# f32; pretrain_sobolev (100 Adam + 10 L-BFGS steps) in float64 at
# SOBOLEV_RTOL (the line search's host branches part f32 runs, phase 9).
SNGD_RTOL, SOBOLEV_RTOL = 1e-4, 1e-8


def _flagship_spec(n: int, width: int, dim: int = 2):
    from gpe_tpu_torch.train.problem import GPESpec

    lim = 8.0 if dim == 2 else 6.0
    return GPESpec(dim=dim, n_points=n, layers=(dim, width, width, width, 1),
                   potential="harmonic", potential_kwargs=(("a", 0.5),), kinetic=0.5,
                   lb=-lim, ub=lim, use_perturbation=False, basis="hermite",
                   nonlinearity="abs_power")


def _grid_oracle(spec, gamma, dev):
    """The port's oracle at the flow endgame's settings on the spec's own
    grid, started from the exact linear ground state (its default ψ₀)."""
    import numpy as np
    from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe

    x1 = np.linspace(spec.lb, spec.ub, spec.n_points)
    V = 0.5 * sum(g ** 2 for g in np.meshgrid(*([x1] * spec.dim), indexing="ij"))
    return imaginary_time_gpe(V, x1[1] - x1[0], gamma, kinetic=0.5, p=spec.p, tau=4e-3,
                              steps=60000, tol=1e-13, richardson=True, device=dev)[0]


def _flow_rungs(spec, gammas, dev):
    """The flagship drivers' pipeline at the 10b depth (FLOW_PRETRAIN,
    FLOW_CUT): the net (seed 0) pretrained to the linear Hermite ground
    state, then one solver call a γ, each warm-started from the last;
    (the FlowResults, the pretraining MSE, the L-BFGS steps run, seconds)."""
    import torch
    from gpe_tpu_torch.models.mlp import init_mlp
    from gpe_tpu_torch.train.pretrain import pretrain_to_base, run_lbfgs
    from gpe_tpu_torch.train.problem import GPESpec, base_triple, make_batch
    from gpe_tpu_torch.train.spectral_flow import make_spectral_flow_solver

    run_lbfgs.steps = 0
    t0 = time.perf_counter()
    batch = make_batch(spec, 0, device=dev)
    params = init_mlp(spec.layers, generator=torch.Generator().manual_seed(0), device=dev)
    base = base_triple(GPESpec(dim=spec.dim, n_points=spec.n_points, lb=spec.lb,
                               ub=spec.ub, basis="hermite"), 0, batch["x"])
    params, pre_mse = pretrain_to_base(params, batch["x"], base.value, spec.activation,
                                       **FLOW_PRETRAIN)
    solver = make_spectral_flow_solver(spec, tau=2e-2, **FLOW_CUT)
    rungs = []
    for g in gammas:
        rungs.append(solver(params, batch, g))
        params = rungs[-1].params
    return rungs, pre_mse, run_lbfgs.steps, time.perf_counter() - t0


def phase_deeponet(dev):
    """10a; returns its numbers."""
    import tempfile

    import numpy as np
    import torch
    from gpe_tpu_torch.deeponet import model as don
    from gpe_tpu_torch.experiments import run
    from gpe_tpu_torch.validate.fdm import solve_gpe_excited_1d

    spec = don.DeepONetSpec(p=3.0)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc = run.main(["deeponet_harmonic", "--train", "--out", out] + DON_RUN)
        wall = time.perf_counter() - t0
        with open(os.path.join(out, "deeponet_harmonic", "summary.json")) as f:
            rec = json.load(f)
    # the evaluation's grid: the batch's f32 points, read back in f64
    x = np.linspace(spec.lb, spec.ub, spec.n_points).astype(np.float32).astype(np.float64)
    worst_oracle = max(abs(r["mu_ref"] - solve_gpe_excited_1d(
        r["beta"] * x ** 2, x[1] - x[0], 1.0, 0, kinetic=spec.kinetic, p=spec.p,
        nonlinearity=spec.nonlinearity, device="cpu")[0]) for r in rec["heldout"])
    log(f"deeponet_harmonic ({' '.join(DON_RUN)}): rc {rc}, {wall:.2f} s, seconds "
        f"{rec['seconds']}; train μ range {rec['train_mu_range']}; held-out max |Δμ| "
        f"interp {rec['interp_max_mu_err']:.4e}, extrap {rec['extrap_max_mu_err']:.4e}; "
        f"the nine oracle μ against the CPU's: max |Δ| {worst_oracle:.3e}")
    if rc != 0 or not all(math.isfinite(r["mu_pred"]) for r in rec["heldout"]) \
            or not worst_oracle <= DON_ORACLE_ATOL:
        raise AssertionError(f"deeponet_harmonic: rc {rc}, oracle {worst_oracle}, {rec}")

    hists = {d: don.train_deeponet(spec, gamma=1.0, epochs=DON_STEPS, pretrain_epochs=0,
                                   device=d).loss_history for d in (dev, "cpu")}
    gap = float(np.max(np.abs(hists[dev] / hists["cpu"] - 1.0)))
    log(f"deeponet fit, card vs CPU over {DON_STEPS} steps: worst loss gap {gap:.3e} "
        f"(loss {hists['cpu'][0]:.4e} → {hists['cpu'][-1]:.4e})")
    if not gap <= DON_RTOL:
        raise AssertionError(f"deeponet fit: card against CPU {gap}")

    sb = np.sqrt(don.make_potential_family_batch(spec, 64, device="cpu")["meta"].numpy())
    orig = don._analytic_family_targets
    errs = {}
    try:
        for label, f in (("true targets", 1.0), ("planted fault (1.5·β)", 1.5)):
            don._analytic_family_targets = (
                lambda b, f=f: orig(dict(b, meta=b["meta"] * f)))
            t0 = time.perf_counter()
            res = don.train_deeponet(spec, gamma=0.0, epochs=0,
                                     pretrain_epochs=DON_PRETRAIN, device=dev)
            errs[label] = float(np.max(np.abs(res.mu_per_fn - sb)))
            log(f"deeponet pretraining ({DON_PRETRAIN} steps, {label}): max |μ − √β| "
                f"{errs[label]:.4e} ({time.perf_counter() - t0:.2f} s)")
    finally:
        don._analytic_family_targets = orig
    if not (errs["true targets"] <= DON_MU_ATOL < errs["planted fault (1.5·β)"]):
        raise AssertionError(f"deeponet pretraining: {errs} against {DON_MU_ATOL}")
    return {"run_s": wall, "seconds": rec["seconds"], "heldout": rec["heldout"],
            "fit_gap": gap, "pretrain_mu_err": errs}


def phase_flagship(dev):
    """10b; returns its numbers."""
    import numpy as np
    import torch
    from gpe_tpu_torch.experiments.gpe2d_flagship import psi_errors
    from gpe_tpu_torch.models.mlp import init_mlp
    from gpe_tpu_torch.train.pretrain import pretrain_to_base
    from gpe_tpu_torch.train.problem import base_triple, make_batch
    from gpe_tpu_torch.train.spectral_flow import make_spectral_flow_solver
    from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe

    spec = _flagship_spec(224, 128)
    rungs, pre_mse, lbfgs_run, wall = _flow_rungs(spec, (2.0, 5.0), dev)
    lbfgs_want = FLOW_PRETRAIN["lbfgs_steps"] + 2 * FLOW_CUT["final_lbfgs_steps"]
    last = rungs[-1]
    # the driver's 384² oracle and ψ errors
    x1 = np.linspace(-8, 8, 384)
    X, Y = np.meshgrid(x1, x1, indexing="ij")
    mu_ref, psi_ref = imaginary_time_gpe(0.5 * (X ** 2 + Y ** 2), x1[1] - x1[0], 5.0,
                                         kinetic=0.5, tau=2e-3, richardson=True,
                                         device=dev)
    psi_l2, _ = psi_errors(last.params, spec, x1, psi_ref)
    mu_oracle = _grid_oracle(spec, 5.0, dev)
    log(f"gpe2d_flagship pipeline (cut): {wall:.2f} s, pretrain MSE {pre_mse:.3e}; rungs "
        f"{[(g, r.mu, r.mu_grid, r.seconds) for g, r in zip((2.0, 5.0), rungs)]}; "
        f"|μ_net − μ_grid| at γ=5 {abs(last.mu - last.mu_grid):.4e}; against the 384² "
        f"oracle: net {abs(last.mu - mu_ref):.4e}, grid {abs(last.mu_grid - mu_ref):.4e}, "
        f"ψ L2 {psi_l2:.4e}; L-BFGS steps run {lbfgs_run} of {lbfgs_want}; the "
        f"endgame's μ_grid {last.mu_grid!r} against the 224² oracle from the linear "
        f"ground state {mu_oracle!r}: |Δ| {abs(last.mu_grid - mu_oracle):.3e}")
    if lbfgs_run != lbfgs_want or not math.isfinite(last.mu):
        raise AssertionError(f"gpe2d_flagship: L-BFGS {lbfgs_run}, μ {last.mu}")
    if not abs(last.mu_grid - mu_oracle) <= FLOW_GRID_ATOL:
        raise AssertionError(f"flow endgame {last.mu_grid} against {mu_oracle}")

    pspec = _flagship_spec(224, FLOW_PARITY_WIDTH)
    batch = make_batch(pspec, 0, device="cpu")
    params = init_mlp(pspec.layers, generator=torch.Generator().manual_seed(0), device="cpu")
    params, _ = pretrain_to_base(params, batch["x"], base_triple(pspec, 0, batch["x"]).value,
                                 pspec.activation, epochs=50, lbfgs_steps=0)
    solver = make_spectral_flow_solver(pspec, outer_steps=FLOW_PARITY_OUTER,
                                       inner_steps=80, final_inner_steps=1,
                                       final_lbfgs_steps=0, endgame_steps=50)
    hist = {}
    for d in (dev, "cpu"):
        b = {k: v.to(d) for k, v in batch.items()}
        r = solver(tuple((w.to(d), c.to(d)) for w, c in params), b, 5.0)
        hist[d] = (r.mu_history[:FLOW_PARITY_OUTER], r.fit_history[:FLOW_PARITY_OUTER],
                   r.seconds["interleave"])
    mu_gap = float(np.max(np.abs(hist[dev][0] / hist["cpu"][0] - 1.0)))
    fit_gap = float(np.max(np.abs(hist[dev][1] / hist["cpu"][1] - 1.0)))
    log(f"flow interleave, card vs CPU ({FLOW_PARITY_OUTER} outer × 80 inner at width "
        f"{FLOW_PARITY_WIDTH}): grid μ gap {mu_gap:.3e}, fit gap {fit_gap:.3e}; "
        f"{hist[dev][2]:.2f} s on the card, {hist['cpu'][2]:.2f} s on the CPU")
    if not (mu_gap <= FLOW_MU_RTOL and fit_gap <= FLOW_FIT_RTOL):
        raise AssertionError(f"flow interleave: card against CPU {mu_gap}, {fit_gap}")
    return {"run_s": wall, "ramp": [{"gamma": g, "mu_net": r.mu, "mu_grid": r.mu_grid,
                                     "seconds": r.seconds}
                                    for g, r in zip((2.0, 5.0), rungs)],
            "abs_err_net": abs(last.mu - mu_ref), "abs_err_grid": abs(last.mu_grid - mu_ref),
            "psi_l2_err": psi_l2, "lbfgs_steps": lbfgs_run,
            "mu_grid_vs_oracle": abs(last.mu_grid - mu_oracle),
            "parity": {"mu_gap": mu_gap, "fit_gap": fit_gap}}


def phase_flagship_artifacts(dev):
    """10c; returns μ per artifact."""
    import torch
    from gpe_tpu_torch.io import load_params
    from gpe_tpu_torch.models.mlp import params_from_numpy
    from gpe_tpu_torch.train.problem import make_batch
    from gpe_tpu_torch.train.spectral_flow import make_spectral_flow_solver

    got = {}
    for name, (n, dim) in (("gpe2d_flagship", (224, 2)), ("gpe3d_ground_state", (36, 3))):
        spec = _flagship_spec(n, 128, dim)
        params = params_from_numpy(load_params(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "runs", name, "params.pkl")),
            device=dev)
        mu, pde = make_spectral_flow_solver(spec).report(
            params, make_batch(spec, 0, device=dev),
            torch.tensor(100.0, device=dev))
        got[name] = float(mu)
        log(f"{name} params through report at γ=100: μ {got[name]!r} (pde {float(pde):.3e})"
            f", the JAX package on a CPU {FLAGSHIP_MU[name]!r}: |Δ| "
            f"{abs(got[name] - FLAGSHIP_MU[name]):.3e}")
        if not abs(got[name] - FLAGSHIP_MU[name]) <= FLAGSHIP_ATOL:
            raise AssertionError(f"{name}: μ {got[name]} against {FLAGSHIP_MU[name]}")
    return got


def phase_3d(dev):
    """10d: the K1 and K2 rows at d = 3, the 3D PL-PINN path's launches and
    one spectral-flow rung at 36³; returns (rows, launches, numbers)."""
    import torch
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.models.mlp import init_mlp
    from gpe_tpu_torch.train.plpinn import train_plpinn
    from gpe_tpu_torch.train.problem import make_batch

    spec = _flagship_spec(36, 128, 3)
    pspec = dataclasses.replace(spec, use_perturbation=True)
    params = init_mlp(spec.layers, generator=torch.Generator().manual_seed(0), device=dev)
    rows = []
    pbatch = make_batch(pspec, 0, device=dev)
    for fn, name in ((phase_k1, "fused_residual_d3"), (phase_k2, "fused_grad_d3")):
        row = fn(pspec, pbatch, params, timing=(5.0, 0.01))
        row["name"] = name
        rows.append(row)
    del pbatch
    k1.collocation_sums.launches = 0
    k2.collocation_grads.launches = 0
    t0 = time.perf_counter()
    res = train_plpinn(pspec, [0.0], modes=(0,), tol=-1.0, patience=10**9,
                       check_every=100, device=dev, **PLPINN3D_RUN)
    plpinn_s = time.perf_counter() - t0
    launches = {"fused_residual": k1.collocation_sums.launches,
                "fused_grad": k2.collocation_grads.launches}
    mu0 = res.mu_table[0][-1][1]
    log(f"3D train_plpinn at 36³ ({PLPINN3D_RUN}): μ(0) {mu0:.7f} (exact 1.5), "
        f"{plpinn_s:.2f} s, launches {launches}")
    if not (abs(mu0 - 1.5) <= CROSS_ATOL and launches["fused_grad"] >= PLPINN3D_RUN["epochs"]
            and launches["fused_residual"] > 0):
        raise AssertionError(f"3D PL-PINN: μ {mu0}, launches {launches}")
    for row in rows:
        row["launches"] = launches[row["name"][:-3]]

    (r,), _, lbfgs_run, wall = _flow_rungs(spec, (5.0,), dev)
    mu_oracle = _grid_oracle(spec, 5.0, dev)
    log(f"3D flow rung at 36³, γ=5: μ_net {r.mu:.7f}, μ_grid {r.mu_grid!r}, oracle "
        f"{mu_oracle!r} (|Δ| {abs(r.mu_grid - mu_oracle):.3e}), |μ_net − μ_grid| "
        f"{abs(r.mu - r.mu_grid):.3e}; {wall:.2f} s {r.seconds}; L-BFGS {lbfgs_run}")
    if not (abs(r.mu_grid - mu_oracle) <= FLOW_GRID_ATOL and math.isfinite(r.mu)
            and lbfgs_run == FLOW_PRETRAIN["lbfgs_steps"] + FLOW_CUT["final_lbfgs_steps"]):
        raise AssertionError(f"3D flow rung: {r.mu_grid} against {mu_oracle}, {r.mu}")
    return rows, launches, {"plpinn_mu0": mu0, "plpinn_s": plpinn_s, "flow": {
        "mu": r.mu, "mu_grid": r.mu_grid, "mu_oracle": mu_oracle, "seconds": r.seconds}}


def phase_sngd(dev):
    """10e; returns its numbers."""
    import numpy as np
    import torch
    from gpe_tpu_torch.models.mlp import init_mlp
    from gpe_tpu_torch.train.pretrain import pretrain_sobolev
    from gpe_tpu_torch.train.problem import base_triple, make_batch
    from gpe_tpu_torch.train.sobolev_ngd import make_sngd_solver

    spec = dataclasses.replace(_flagship_spec(32, 32), layers=(2, 32, 32, 1),
                               activation="tanh")
    batch = make_batch(spec, 0, device="cpu")
    params = init_mlp(spec.layers, generator=torch.Generator().manual_seed(0), device="cpu")
    solver = make_sngd_solver(spec, outer_steps=5, inner_steps=20)
    out = {}
    for d in (dev, "cpu"):
        r = solver(tuple((w.to(d), b.to(d)) for w, b in params),
                   {k: v.to(d) for k, v in batch.items()}, 5.0)
        out[d] = (r.mu_history, r.loss_history)
    gaps = [float(np.max(np.abs(out[dev][i] / out["cpu"][i] - 1.0))) for i in (0, 1)]
    base = base_triple(spec, 0, batch["x"].double())
    sob = {}
    for d in (dev, "cpu"):
        p64 = tuple((w.to(d, torch.float64), b.to(d, torch.float64)) for w, b in params)
        sob[d] = pretrain_sobolev(p64, batch["x"].to(d, torch.float64), base.value,
                                  base.grad[..., None], "tanh", epochs=100,
                                  lbfgs_steps=10)[1]
    sob_gap = abs(sob[dev] / sob["cpu"] - 1.0)
    log(f"SNGD (2D 32², 5 × 20), card vs CPU: μ gap {gaps[0]:.3e}, residual gap "
        f"{gaps[1]:.3e}; pretrain_sobolev in f64 (100 + 10 steps): loss {sob[dev]!r} vs "
        f"{sob['cpu']!r}, gap {sob_gap:.3e}")
    if not (max(gaps) <= SNGD_RTOL and sob_gap <= SOBOLEV_RTOL):
        raise AssertionError(f"SNGD / pretrain_sobolev: {gaps}, {sob_gap}")
    return {"sngd_gaps": gaps, "sobolev_gap": sob_gap}


def phase_flow(dev):
    """Phase 10 (a)–(e); returns (the d = 3 kernel rows, the launches of
    every kernel over 10a, 10b, 10c and 10e, all 0, and of 10d, its
    numbers)."""
    counters = _kernel_counters()
    for _, reset in counters.values():
        reset()
    out = {}
    t0 = time.perf_counter()
    out["deeponet"] = phase_deeponet(dev)
    out["flagship"] = phase_flagship(dev)
    out["artifacts"] = phase_flagship_artifacts(dev)
    out["sngd"] = phase_sngd(dev)
    launches = {name: read() for name, (read, _) in counters.items()}
    log(f"phase 10 (a, b, c, e) launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 10 (a, b, c, e) launched kernels: {launches}")
    rows, launches_3d, out["3d"] = phase_3d(dev)
    out["phase_s"] = time.perf_counter() - t0
    return rows, launches, launches_3d, out


# ---- phase 11: K2's bf16 operand mode, the rotating frame, the dynamics drivers

K2_BF16_TOL = 2e-4     # normalised, K2-bf16 against its bf16 plain version (K2's own
#                        limit; tests/test_torch_k2_bf16.py holds the plain version to
#                        JAX's bf16 kernel at the same bound)
K2_BF16_VS_F32 = 1e-2  # normalised, K2-bf16 against f32 K2: the JAX docstring's ~1e-2
# 10 relaxed bf16 fit steps, card against CPU, per loss. From
# `experiments/bf16_fit_controls.py` (NVIDIA H100 80GB HBM3, 700 W): routes
# that differ from the card's in f32 rounding alone (run again, points
# reordered, the CPU) part by ≤ 1.0e-4 (≤ 6.7e-5 with the FFMA forward of
# K2-bf16 before its tensor-core redesign), the planted faults (stale
# cotangents, the output bias's gradient dropped) by ≥ 1.85e-2; the bound
# sits between, 10x and 18x from each. (The exact bf16 step parts by
# 4.6e-2–8.6e-2: its cotangents come from K1-bf16's sums, which round the
# weights too.)
FIT_BF16_RTOL = 1e-3
ROT_F64_ATOL = 1e-12   # the rotating stepper in f64, card against CPU


def bound_k2_bf16(layers, n: int, runs: int = 1):
    """(least ms, "operations" or "bytes") of K2's bf16 mode. Its forward
    and backprop products multiply a bf16 operand by an f32 weight. The
    card does that fastest, at full f32 accuracy, as three bf16 × bf16
    products: the f32 weight split into three bf16 terms holds all 24 bits
    of its mantissa, each bf16 × bf16 product is exact in an f32
    accumulator, and the bf16 operand is one exact term — so those FLOPs
    count at the dense bf16 rate over three (989/3 TFLOP/s; two TF32 terms,
    495/2, would be slower and hold only ~22 bits). Its W̄ products are
    bf16 × bf16 (the dense bf16 rate, 989). Bytes as `io_bytes`."""
    from gpe_tpu_torch.bench import PEAK_FLOPS, matmul_flops
    d, C = layers[0], layers[0] + 2
    hidden = sum(2 * C * k * m for k, m in zip(layers[1:-2], layers[2:-1]))
    wbar = (hidden + 4 * layers[-2] + 2 * (d + 1) * layers[1]) * n
    fwd_bp = matmul_flops(layers, n, grad=False) + hidden * n
    t_ops = runs * (fwd_bp / (PEAK_FLOPS["bf16"] / 3) + wbar / PEAK_FLOPS["bf16"]) * 1e3
    t_mem = io_bytes(layers, n, True, runs) / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def phase_k2_bf16(label, spec, batch, params, gammas=None, scales=None):
    """K2-bf16 (gammas None) or K3-grads-bf16 and K3-sums-bf16 (run-stacked
    params, per-run γ and scale) against their bf16 plain versions (sums
    BF16_TOL, gradients K2_BF16_TOL) with exact and stale cotangents,
    against the f32 kernel (K2_BF16_VS_F32), and a planted fault that must
    fail: the plain version with its weights rounded to bf16 in the forward,
    as K1's mode rounds them. Timed as kernel, bf16 plain version and
    library (nested autograd of the same loss in bf16). Returns the rows."""
    import torch
    from gpe_tpu_torch.bench import nested_autograd_sums
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.kernels.fused_residual import _bf16

    bf16 = torch.bfloat16
    runs = gammas is not None
    R = scales.shape[0] if runs else 1
    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    g0, s0 = (gammas, scales) if runs else (5.0, 0.05)
    args = (batch["x"], batch["V"], batch["w"])
    base = (batch.get("base_val"), batch.get("base_lap"))
    n = batch["x"].shape[0]
    sums_fn = k1.collocation_sums_runs if runs else k1.collocation_sums
    grads_fn = k2.collocation_grads_runs if runs else k2.collocation_grads
    plain_fn = (k2.collocation_grads_runs_bf16_plain if runs
                else k2.collocation_grads_bf16_plain)
    rounded = tuple((_bf16(W), b) for W, b in params)
    rows, worst, sums_rel, fault_min, f32_max = [], 0.0, 0.0, math.inf, 0.0
    cases = ((g0, s0),) if runs else ((5.0, 0.05), (100.0, 1.0))
    for gamma, scale in cases:
        sums = sums_fn(params, *args, gamma, scale, *base, **kw, compute_dtype=bf16)
        if runs:
            psums = k1.collocation_sums_runs_plain(params, *args, gamma, scale, *base,
                                                   **kw, compute_dtype=bf16)
            rel = _rel(sums, psums)
            log(f"K3 sums bf16 {label}: vs bf16 plain max rel {rel:.2e}")
            if not torch.isfinite(sums).all() or rel > BF16_TOL:
                raise AssertionError(f"K3 sums bf16 disagrees with its plain version: "
                                     f"{rel:.3e}")
            sums_rel = max(sums_rel, rel)
        cots = k1.sums_to_loss(sums, n, spec.norm_weight)[3]
        stale = k1.sums_to_loss(sums * torch.tensor([1.3, 0.9, 1.1, 0.8],
                                                    device=sums.device),
                                n, spec.norm_weight)[3]
        for mode, c in (("exact", cots), ("delayed", stale)):
            got, s_got = grads_fn(params, *args, gamma, scale, c, *base, **kw,
                                  compute_dtype=bf16)
            want, s_want = plain_fn(params, *args, gamma, scale, c, *base, **kw)
            f32, _ = grads_fn(params, *args, gamma, scale, c, *base, **kw)
            fault, _ = plain_fn(rounded, *args, gamma, scale, c, *base, **kw)
            torch.cuda.synchronize()
            ab, norm = _grad_err(got, want)
            _, vs_f32 = _grad_err(got, f32)
            _, vs_fault = _grad_err(fault, got)
            s_rel = _rel(s_got, s_want)
            log(f"K2 bf16 {label} {mode} γ={gamma if not runs else 'per run'}: grads "
                f"normalised {norm:.2e} vs bf16 plain, {vs_f32:.2e} vs f32 K2; planted "
                f"fault (weights rounded) {vs_fault:.2e}; sums vs plain {s_rel:.2e}")
            if (norm > K2_BF16_TOL or s_rel > BF16_TOL or vs_f32 > K2_BF16_VS_F32
                    or not math.isfinite(ab)):
                raise AssertionError(f"K2 bf16 {label} ({mode}) disagrees: {norm:.3e}, "
                                     f"f32 {vs_f32:.3e}, sums {s_rel:.3e}")
            if not vs_fault > K2_BF16_TOL:
                raise AssertionError(f"K2 bf16 {label}: the planted fault passes "
                                     f"({vs_fault:.3e} ≤ {K2_BF16_TOL})")
            worst, fault_min = max(worst, ab), min(fault_min, vs_fault)
            f32_max = max(f32_max, vs_f32)
    sums = sums_fn(params, *args, g0, s0, *base, **kw, compute_dtype=bf16)
    cots = k1.sums_to_loss(sums, n, spec.norm_weight)[3]
    leaves = [t.detach().to(bf16).requires_grad_(True) for pair in params for t in pair]
    pairs = tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))
    b16 = {k: v.to(bf16) for k, v in batch.items()}

    def library():
        if runs:
            s = _nested_runs(pairs, b16, gammas, scales, spec)
        else:
            s = nested_autograd_sums(pairs, b16, g0, s0, spec.activation, spec.p,
                                     spec.kinetic, spec.nonlinearity)
        return torch.autograd.grad(torch.sum(cots.to(bf16) * s), leaves)

    ms, call_ms = kernel_ms(lambda: grads_fn(params, *args, g0, s0, cots, *base, **kw,
                                             compute_dtype=bf16), 20)
    plain_ms = time_ms(lambda: plain_fn(params, *args, g0, s0, cots, *base, **kw), 5)
    lib_ms = time_ms(library, 3)
    b_ms, b_by = bound_k2_bf16(spec.layers, n, R)
    f32_ms, _ = kernel_ms(lambda: grads_fn(params, *args, g0, s0, cots, *base, **kw), 20)
    log(f"K2 bf16 {label} timing: kernel {ms:.4f} ms (per call {call_ms:.4f}), f32 kernel "
        f"{f32_ms:.4f} ms, bf16 plain {plain_ms:.4f} ms, nested autograd in bf16 "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of it")
    rows.append({"name": "fused_grad_runs_bf16" if runs else "fused_grad_bf16",
                 "route": "cuda", "source": "gpe_tpu_torch/csrc/fused_grad.cu",
                 "replaces": "gpe_tpu/pallas/fused_grad.py:396", "shape": label,
                 "max_abs_err": worst, "vs_f32_normalised": f32_max,
                 "planted_fault_normalised": fault_min, "ms": ms, "call_ms": call_ms,
                 "f32_ms": f32_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms})
    if runs:
        s_ms, s_call = kernel_ms(lambda: k1.collocation_sums_runs(
            params, *args, g0, s0, *base, **kw, compute_dtype=bf16), 50)
        s_plain = time_ms(lambda: k1.collocation_sums_runs_plain(
            params, *args, g0, s0, *base, **kw, compute_dtype=bf16), 5)
        s_lib = time_ms(lambda: _nested_runs(tuple((W.to(bf16), b.to(bf16))
                                                   for W, b in params), b16, gammas,
                                             scales, spec), 3)
        sb_ms, sb_by = bound(spec.layers, n, grad=False, runs=R, operands="bf16")
        log(f"K3 sums bf16 {label} timing: kernel {s_ms:.4f} ms (per call {s_call:.4f}), "
            f"bf16 plain {s_plain:.4f} ms, nested autograd in bf16 {s_lib:.4f} ms, bound "
            f"{sb_ms:.4f} ms ({sb_by})")
        rows.append({"name": "fused_residual_runs_bf16", "route": "cuda",
                     "source": "gpe_tpu_torch/csrc/fused_residual.cu",
                     "replaces": "gpe_tpu/pallas/fused_residual.py:246", "shape": label,
                     "max_abs_err": float((sums - k1.collocation_sums_runs_plain(
                         params, *args, g0, s0, *base, **kw,
                         compute_dtype=bf16)).abs().max()),
                     "max_rel_err": sums_rel, "ms": s_ms, "call_ms": s_call,
                     "plain_ms": s_plain, "bound_ms": sb_ms, "bound_by": sb_by,
                     "library_ms": s_lib})
    return rows


def _hist_rel(got, want) -> float:
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def phase_bf16_fits(dev):
    """11a's path: `bf16_fit_controls.fits` — 10 steps of
    `fit(value_and_grad_fn=)` with the default relaxed bf16 vag at the main
    shape and 10 of `fit_ensemble` with it (its run-axis twin on K3) at
    harmonic_paper's six runs — on the card with every launch counter set
    to 0 just before and read just after; then the same steps on the CPU
    from the same params (FIT_BF16_RTOL per loss), the f32 route on the
    card (within the bench's bf16 limit LOSS_TOL_BF16), and each planted
    fault of `sweep_controls.FAULTS` in the relaxed bf16 step, which must
    part from the card's route by more than FIT_BF16_RTOL in both fits.
    Returns (launches, record)."""
    import torch
    from gpe_tpu_torch.bench import LOSS_TOL_BF16
    from gpe_tpu_torch.experiments import bf16_fit_controls as bc
    from gpe_tpu_torch.experiments.sweep_controls import FAULTS

    probs = bc.problems(dev)
    counters = _kernel_counters()
    for _, reset in counters.values():
        reset()
    t0 = time.perf_counter()
    card = bc.fits(probs, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {name: read() for name, (read, _) in counters.items()}
    log(f"phase 11a bf16 fits launches {launches} ({card_s:.2f} s)")
    need = ("fused_grad_bf16", "fused_grad_runs_bf16", "fused_residual_runs_bf16")
    if not all(launches[k] for k in need) or launches["fused_grad"] \
            or launches["fused_grad_runs"]:
        raise AssertionError(f"the bf16 fits did not run on the bf16 kernels: {launches}")
    t0 = time.perf_counter()
    host = bc.fits(probs, torch.device("cpu"))
    rec = {"card_s": card_s, "cpu_s": time.perf_counter() - t0,
           "vs_cpu": bc.gaps(card, host),
           "vs_f32": bc.gaps(card, bc.fits(probs, dev, dtype=torch.float32)),
           "faults": {f: bc.gaps(bc.fits(probs, dev, f), card) for f in FAULTS}}
    for i, what in enumerate(("fit", "fit_ensemble")):
        log(f"bf16 {what}: 10-step losses card vs CPU max rel {rec['vs_cpu'][what]:.2e}, "
            f"vs the f32 route {rec['vs_f32'][what]:.2e}, planted faults "
            f"{ {f: f'{g[what]:.2e}' for f, g in rec['faults'].items()} }; "
            f"last loss {card[i].loss_history[..., -1]}")
    if not (all(v <= FIT_BF16_RTOL for v in rec["vs_cpu"].values())
            and all(v < LOSS_TOL_BF16 for v in rec["vs_f32"].values())
            and all(v > FIT_BF16_RTOL for g in rec["faults"].values() for v in g.values())):
        raise AssertionError(f"bf16 fits: {rec}")
    return launches, rec


def phase_rotating_oracles(dev):
    """11b: tests/test_rotating_dynamics.py's oracles in float64 on the card
    — rotating-frame Kohn splitting (centre 2e-5, norm 1e-11, energy 2e-5),
    agreement with the port's f64 ADI oracle (μ, L_z 1e-9, overlap 1e-11),
    the remainder record — and `evolve_rotating` card against CPU
    (ROT_F64_ATOL)."""
    import numpy as np
    import torch
    from gpe_tpu_torch.dynamics import evolve_rotating, rotating_ground_state
    from gpe_tpu_torch.validate.rotating import rotating_imaginary_time

    def grid(n, half):
        x = np.linspace(-half, half, n, endpoint=False)
        X, Y = np.meshgrid(x, x, indexing="ij")
        return x, x[1] - x[0], X, Y

    out = {}
    x, dx, X, Y = grid(96, 8.0)
    V = 0.5 * (X ** 2 + Y ** 2)
    psi0 = np.exp(-0.5 * ((X - 0.5) ** 2 + Y ** 2))
    psi0 = psi0 / np.sqrt(np.sum(psi0 ** 2) * dx * dx)
    t0 = time.perf_counter()
    _, obs = evolve_rotating(psi0, V, dx, 2e-3, 3000, 20.0, 0.5, lb=float(x[0]),
                             record_every=100, device=dev)
    t = obs["t"]
    kohn = max(float(np.max(np.abs(obs["center"][:, 0] - 0.5 * np.cos(t) * np.cos(0.5 * t)))),
               float(np.max(np.abs(obs["center"][:, 1] + 0.5 * np.cos(t) * np.sin(0.5 * t)))))
    norm = float(np.max(np.abs(obs["norm"] - 1.0)))
    energy = float(np.max(np.abs(obs["energy"] / obs["energy"][0] - 1.0)))
    out["kohn"] = {"centre": kohn, "norm": norm, "energy": energy,
                   "s": time.perf_counter() - t0}
    log(f"11b Kohn splitting (96², 3000 f64 steps on the card): centre {kohn:.2e}, "
        f"norm {norm:.2e}, energy {energy:.2e} ({out['kohn']['s']:.1f} s)")
    if not (kohn < 2e-5 and norm < 1e-11 and energy < 2e-5):
        raise AssertionError(f"rotating Kohn oracle fails on the card: {out['kohn']}")
    rng = np.random.default_rng(3)
    seed = np.exp(-(X ** 2 + Y ** 2) / 2.0) * ((X - 0.3) + 1j * (Y + 0.2))
    seed = seed + 0.01 * (rng.standard_normal(seed.shape)
                          + 1j * rng.standard_normal(seed.shape))
    mu_o, psi_o, lz_o = rotating_imaginary_time(V, x, 30.0, 0.7, tau=2e-3, steps=1200,
                                                tol=0.0, psi0=seed, device=dev)
    mu, psi, lz = rotating_ground_state(V, dx, 30.0, 0.7, tau=2e-3, steps=1200, tol=0.0,
                                        lb=float(x[0]), psi0=seed, chunk=200, device=dev)
    ov = abs(float(abs(torch.sum(torch.conj(psi) * psi_o) * dx * dx)) - 1.0)
    out["oracle"] = {"mu": abs(mu - mu_o), "lz": abs(lz - lz_o), "overlap": ov}
    log(f"11b against the f64 ADI oracle: |Δμ| {out['oracle']['mu']:.2e}, |ΔL_z| "
        f"{out['oracle']['lz']:.2e}, |overlap − 1| {ov:.2e}")
    if not (out["oracle"]["mu"] < 1e-9 and out["oracle"]["lz"] < 1e-9 and ov < 1e-11):
        raise AssertionError(f"the stepper leaves the f64 oracle: {out['oracle']}")
    x, dx, X, Y = grid(64, 6.0)
    V = 0.5 * (X ** 2 + Y ** 2)
    p0 = np.exp(-0.5 * ((X - 0.4) ** 2 + Y ** 2)).astype(complex)
    p0 = p0 / np.sqrt(np.sum(np.abs(p0) ** 2) * dx * dx)
    (pa, oa), (pb, ob), (pc, oc) = (
        evolve_rotating(p0, V, dx, 1e-3, 130, 5.0, 0.3, lb=float(x[0]),
                        record_every=every, device=device)
        for every, device in ((50, dev), (130, dev), (50, torch.device("cpu"))))
    rem = len(oa["t"]) == 4 and abs(oa["t"][-1] - 0.130) < 1e-12
    same = float((pa - pb).abs().max())
    cpu_err = max(float((pa.cpu() - pc).abs().max()),
                  max(float(np.max(np.abs(oa[k] - oc[k]))) for k in
                      ("norm", "energy", "mu", "lz", "center", "width_sq")))
    out["remainder"] = {"records": len(oa["t"]), "vs_one_record": same,
                        "card_vs_cpu": cpu_err}
    log(f"11b remainder record {len(oa['t'])} rows, ψ vs one record {same:.2e}; card vs "
        f"CPU {cpu_err:.2e}")
    if not (rem and same < 1e-14 and cpu_err < ROT_F64_ATOL):
        raise AssertionError(f"remainder record / card vs CPU: {out['remainder']}")
    return out


def phase_vortex_trainer(dev):
    """11c: `train_rotating_vortex` at full width ([2,128,128,128,2], n 128,
    sin/siren, w0 3, γ 50, Ω 0.7, Sobolev at 128²), cut: 300 distillation
    and 20 L-BFGS steps, 5 LM steps of 100 CG iterations. The f64 oracle
    (on the card) must hold one vortex and L_z within 0.05 of 1; the rotating
    loss (1e-5) and its flat gradient (1e-4 of its largest entry) at the
    initial params card against CPU, and 20 Sobolev Adam steps card against
    CPU (loss 1e-4)."""
    import numpy as np
    import torch
    from gpe_tpu_torch.models.mlp import init_mlp
    from gpe_tpu_torch.rotating import (RotatingSpec, make_rotating_batch,
                                        make_rotating_loss_fn, train_rotating_vortex)
    from gpe_tpu_torch.train.pretrain import AdamSteps, _leaves, _pairs, _sobolev_loss

    spec = RotatingSpec(n_points=128, layers=(2, 128, 128, 128, 2), activation="sin",
                        init_scheme="siren", w0=3.0, gamma=50.0, omega=0.7)
    out = {}
    cpu = torch.device("cpu")
    p = {d.type: init_mlp(spec.layers, "siren", w0=3.0,
                          generator=torch.Generator().manual_seed(0), device=d)
         for d in (dev, cpu)}
    b = {d.type: make_rotating_batch(spec, d) for d in (dev, cpu)}
    loss_fn = make_rotating_loss_fn(spec)
    vals = {}
    for d in ("cuda", "cpu"):
        leaves = _leaves(p[d])
        with torch.enable_grad():
            total, aux = loss_fn(_pairs(leaves), b[d], 50.0, 0.7)
            grads = torch.autograd.grad(total, leaves)
        vals[d] = (float(total.detach()), torch.cat([g.cpu().reshape(-1) for g in grads]))
    # over the flat gradient: the bias gradients vanish by the grid's
    # symmetry at this init (~1e-10 of the largest in f64)
    gerr = float((vals["cuda"][1] - vals["cpu"][1]).abs().max()
                 / vals["cpu"][1].abs().max())
    lerr = abs(vals["cuda"][0] - vals["cpu"][0]) / abs(vals["cpu"][0])
    hist = {}
    x = b["cpu"]["x"]
    tval = torch.stack([torch.exp(-0.5 * (x ** 2).sum(-1)), 0.1 * x[:, 0]], -1)
    tjac = torch.stack([-x * tval[:, :1], torch.stack([0.1 * torch.ones_like(x[:, 0]),
                                                       torch.zeros_like(x[:, 0])], -1)],
                       dim=-1)
    for d in (dev, cpu):
        leaves = _leaves(p[d.type])
        loss = _sobolev_loss(x.to(d), tval.to(d), tjac.to(d), spec.activation, 0.1)
        steps = AdamSteps(lambda: loss(leaves), leaves, 1e-3, d.type == "cuda")
        hist[d.type] = [float(steps.run(1)) for _ in range(20)]
    aerr = _hist_rel(hist["cuda"], hist["cpu"])
    out["card_vs_cpu"] = {"loss": lerr, "grads": gerr, "sobolev_adam_20": aerr}
    log(f"11c card vs CPU at full width: loss {lerr:.2e}, gradient {gerr:.2e} "
        f"normalised; 20 Sobolev Adam steps {aerr:.2e}")
    if not (lerr < 1e-5 and gerr < 1e-4 and aerr < 1e-4):
        raise AssertionError(f"the rotating trainer leaves the CPU: {out['card_vs_cpu']}")
    t0 = time.perf_counter()
    res = train_rotating_vortex(spec, fit_epochs=300, lbfgs_steps=20, polish_steps=5,
                                polish_cg_iters=100, sobolev=True, sobolev_n=128,
                                verbose=True, device=dev)
    out["trainer"] = {"s": time.perf_counter() - t0, "mu": res.mu, "mu_grid": res.mu_grid,
                      "lz": res.lz, "lz_grid": res.lz_grid, "n_vortices": res.n_vortices,
                      "pde": res.pde_loss, "fit_mse": res.fit_mse}
    log(f"11c train_rotating_vortex (cut): {json.dumps(out['trainer'])}")
    if not (res.n_vortices == 1 and abs(res.lz_grid - 1.0) < 0.05
            and all(np.isfinite([res.mu, res.lz, res.pde_loss, res.energy]))):
        raise AssertionError(f"the Ω = 0.7 oracle/trainer: {out['trainer']}")
    return out


def phase_dynamics_drivers(dev, tmp):
    """11d: the four drivers at cut depth on the card into `tmp`:
    rotating_dynamics (n 128, 3,000 spin-up steps, 1,000 + 4,000 real-time
    steps: the Kohn fit within 1e-3 of 1 ± Ω, norm drift < 1e-10);
    gpe_dynamics 2D in f64 and --f32 (n 256, the default 6,000 steps — at
    1,200 the kinetic phase per step reaches 23 rad and the breathing fit
    fails in f64 too — 3,000 ground-state steps; Kohn ω within 1e-3 of 1,
    breathing within 1e-2 of 2); gpe2d_vortex
    at Ω 0.9 from the committed oracle cache (300 + 10 distillation steps,
    2 LM steps); gpe2d_vortex_config with a cut configuration
    ({"v": [64, [80]]}, 2,000 + 1,000 steps) and its net stage."""
    import numpy as np
    from gpe_tpu_torch.experiments import (gpe2d_vortex, gpe2d_vortex_config,
                                           gpe_dynamics, rotating_dynamics)

    out, t0 = {}, time.perf_counter()
    rotating_dynamics.main(["--n", "128", "--spinup-steps", "3000", "--rt-steps", "1000",
                            "--kohn-steps", "4000", "--out", f"{tmp}/rd"])
    rd = json.load(open(f"{tmp}/rd/summary.json"))
    kohn = rd["kohn_splitting"]
    out["rotating_dynamics"] = {"s": time.perf_counter() - t0, "spinup": rd["spinup_final"],
                                "omega_plus_err": kohn["omega_plus_abs_err"],
                                "omega_minus_err": kohn["omega_minus_abs_err"],
                                "norm_drift": rd["stationarity"]["norm_drift"]}
    if not (kohn["omega_plus_abs_err"] < 1e-3 and kohn["omega_minus_abs_err"] < 1e-3
            and rd["stationarity"]["norm_drift"] < 1e-10):
        raise AssertionError(f"rotating_dynamics (cut): {out['rotating_dynamics']}")
    for f32 in (False, True):
        t0 = time.perf_counter()
        gpe_dynamics.main(["--n", "256", "--steps", "6000", "--gs-steps", "3000",
                           "--out", f"{tmp}/gd"] + (["--f32"] if f32 else []))
        s = json.load(open(f"{tmp}/gd/summary{'_f32' if f32 else ''}.json"))
        key = "f32" if f32 else "f64"
        out[f"gpe_dynamics_{key}"] = {"s": time.perf_counter() - t0,
                                      "kohn": s["kohn_dipole"]["abs_err"],
                                      "breathing": s["breathing_2d"]["abs_err"],
                                      "norm_drift": s["norm_drift"],
                                      "throughput": s["throughput_grid_pt_steps_per_sec"]}
        if not (s["kohn_dipole"]["abs_err"] < 1e-3 and s["breathing_2d"]["abs_err"] < 1e-2):
            raise AssertionError(f"gpe_dynamics (cut, {key}): {out[f'gpe_dynamics_{key}']}")
    t0 = time.perf_counter()
    gpe2d_vortex.main(["--omegas", "0.9", "--fit-epochs", "300", "--lbfgs-steps", "10",
                       "--polish-steps", "2", "--out", f"{tmp}/gv"])
    row = json.load(open(f"{tmp}/gv/summary.json"))["results"][0]
    out["gpe2d_vortex"] = {"s": time.perf_counter() - t0, "mu_net": row["mu_net"],
                           "mu_grid": row["mu_grid"], "oracle": row["settings"]["oracle"],
                           "n_vortices": row["n_vortices"]}
    if not (row["settings"]["oracle"] == "v7" and row["n_vortices"] == 7
            and np.isfinite(row["mu_net"])):
        raise AssertionError(f"gpe2d_vortex (cut): {out['gpe2d_vortex']}")
    t0 = time.perf_counter()
    table = gpe2d_vortex_config.stage_oracle(2000, 1000, 2e-3, f"{tmp}/gvc",
                                             {"v": (64, (80,))}, dev)
    rec = gpe2d_vortex_config.stage_net(64, 64, 100, 5, 1, cg_iters=20, sobolev_n=64,
                                        out=f"{tmp}/gvc", device=dev)
    out["gpe2d_vortex_config"] = {"s": time.perf_counter() - t0,
                                  "mu_star": table["v"]["mu_star"],
                                  "mu_net": rec["per_config"]["v"]["mu_net"]}
    if not np.isfinite(rec["per_config"]["v"]["mu_net"]):
        raise AssertionError(f"gpe2d_vortex_config (cut): {out['gpe2d_vortex_config']}")
    log(f"11d drivers (cut): {json.dumps(out)}")
    return out


def phase_rotating(dev, tmp):
    """Phase 11 (a)–(d), 11d's drivers writing into `tmp`; returns (the
    bf16 kernel rows, the launches of 11a's fits, of 11b–d (all 0), the
    record)."""
    import torch

    t0 = time.perf_counter()
    _, spec, batch, params = main_shape(dev)
    rows = phase_k2_bf16("main", spec, batch, params)
    del batch, params
    bspec, bbatch, bparams = bench_shape(dev)
    rows[0]["bench_shape"] = phase_k2_bf16("bench", bspec, bbatch, bparams)[0]
    del bbatch, bparams
    _, rspec, rbatch, rparams, gammas, scales = runs_shape(dev)
    rows += phase_k2_bf16("runs", rspec, rbatch, rparams, gammas, scales)
    del rbatch, rparams
    torch.cuda.empty_cache()
    fit_launches, out = phase_bf16_fits(dev)
    counters = _kernel_counters()
    for _, reset in counters.values():
        reset()
    out["oracles"] = phase_rotating_oracles(dev)
    out["trainer"] = phase_vortex_trainer(dev)
    out["drivers"] = phase_dynamics_drivers(dev, tmp)
    launches = {name: read() for name, (read, _) in counters.items()}
    log(f"phase 11 (b–d) launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 11 (b–d) launched kernels: {launches}")
    out["phase_s"] = time.perf_counter() - t0
    return rows, fit_launches, launches, out


# ---- phase 12: the numeric bases and the optical-lattice drivers (BASELINE #4)

LATTICE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs", "gpe2d_lattice")
NUMERIC_F64_RTOL = 1e-11   # the sine-series base card vs CPU in float64, per field,
#                            of its max |·| (tests/test_torch_numeric.py's bound
#                            against the JAX package)
NUMERIC_CALLS = 50         # 12b: card calls of the base, the first kept apart
# 12c: the oracle at lattice_summary.py's settings (n 255, τ 2e-3, Richardson
# 2) on the committed cache's V at LATTICE_ORACLE_GAMMAS, against the
# committed mu_refs; the port's own V (float32, as JAX evaluates it) is
# held to the cache's within two float32 ulps of V's largest value (8).
# γ 0 only: its γ 5 rung (53 s on the card) was cut to keep the script
# under its time limit; 12e's flagship endgame still solves the γ 5 grid
# problem on the card, held to the committed γ 5 mu_ref (reads 4.5e-7).
LATTICE_ORACLE_GAMMAS = (0.0,)
LATTICE_ORACLE_ATOL = 1e-9
LATTICE_V_ATOL = 2e-6
# 12d: gpe2d_lattice_plpinn's train_plpinn at full width, ramp 0, 0.5, 1.0
# of 300 epochs, 20 LM steps (+ the float64 endgame) at γ = 0; μ_lm(0)
# within LATTICE_PL_ATOL of the committed oracle's μ(0); the planted fault
# (the base's Laplacian zeroed) must miss it.
LATTICE_PLPINN = dict(ramp=[0.0, 0.5, 1.0], epochs=300, lm_steps=20)
LATTICE_PL_ATOL = 1e-2
# 12e: the JAX lattice flagship's params (runs/gpe2d_lattice/
# ground_state_params.pkl) through the flow solver's `report` at γ = 20,
# the JAX package's report arithmetic in f32 on a CPU (matmul precision
# "highest"; tests/test_torch_lattice.py recomputes it with JAX); its
# summary.json row, computed on the TPU, records 2.611372470855713. The
# port's CPU report reads 7.2e-7 (3 ulps) off it.
LATTICE_FLAGSHIP_MU = 2.611255168914795
LATTICE_FLAGSHIP_ATOL = 2e-6
# 12e cut: the flagship's pipeline at one γ = 5 rung (FLOW_PRETRAIN,
# FLOW_CUT, bc "dirichlet"); stage_net from the committed band cache with
# BAND_NET's steps (its 800 L-BFGS steps are stage_net's own).
# At this depth the net's μ is not yet the state's (0.96 off E0*: a distill
# MSE of 1.3e-3 on an H100), so the check is the orthogonality
# rows': after the polish every projection onto the excited band states
# stays under BAND_NET_PROJ (reads 7.3e-3).
BAND_NET = dict(pretrain_epochs=300, polish_steps=5)
BAND_NET_PROJ = 0.05
# The cut flagship rung's μ_grid (its f64 endgame on the 128² collocation
# grid) against the committed 255² oracle at γ = 5: reads 4.5e-7.
LATTICE_FLOW_GRID_ATOL = 1e-5


class _ZeroLap:
    """A planted fault of a numeric base: its Laplacian zeroed."""

    def __init__(self, series):
        self.series = series

    def __call__(self, pts):
        import torch
        from gpe_tpu_torch.physics.bases import ValGradLap
        t = self.series(pts)
        return ValGradLap(t.value, t.grad, torch.zeros_like(t.lap))


def phase_lattice_kernels(dev, series, lb, ub):
    """12a, 12b: the K1 and K2 rows at the lattice shape (16,384 points,
    [2,128,128,128,1], the numeric base from the committed cache, timed at
    γ 5, s 0.05), and the base card against CPU in float64."""
    import numpy as np
    import torch
    from gpe_tpu_torch.experiments import gpe2d_lattice_plpinn as lp
    from gpe_tpu_torch.models.mlp import init_mlp
    from gpe_tpu_torch.physics.numeric import register_numeric_basis
    from gpe_tpu_torch.train.problem import make_batch

    spec = lp.lattice_spec(register_numeric_basis("lattice_gs", series), lb, ub)
    batch = make_batch(spec, 0, device=dev)
    params = init_mlp(spec.layers, "xavier_uniform",
                      generator=torch.Generator().manual_seed(0), device=dev)
    rows = []
    for fn, name in ((phase_k1, "fused_residual_lattice"), (phase_k2, "fused_grad_lattice")):
        row = fn(spec, batch, params, timing=(5.0, 0.05))
        row["name"] = name
        rows.append(row)
    x = batch["x"].double()
    t0 = time.perf_counter()
    card = series(x)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = series(x.cpu())

    def rel(call):
        return [float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in zip(call, cpu)]

    errs = rel(card)
    calls = [series(x) for _ in range(NUMERIC_CALLS - 1)]
    again = [float((a - b).abs().max()) for a, b in zip(calls[0], card)]
    later = max(max(rel(c)) for c in calls)
    varied = sum(not all(torch.equal(a, b) for a, b in zip(c, calls[0])) for c in calls)
    log(f"12b numeric base at the 16,384 points in f64, card vs CPU: value, ∇, Δ "
        f"{errs} of max |·| (bound {NUMERIC_F64_RTOL}); a second card call's max |Δ| "
        f"{again}; the {len(calls)} later calls' largest error {later:.3e}, "
        f"{varied} of them not bitwise equal to the second; {1e3 * card_s:.2f} ms on "
        f"the card")
    if not (max(errs) <= NUMERIC_F64_RTOL and later <= NUMERIC_F64_RTOL
            and all(np.isfinite(errs))):
        raise AssertionError(f"numeric base card vs CPU: first {errs}, later {later}")
    return rows, {"numeric_base_f64_err": errs, "numeric_base_ms": 1e3 * card_s,
                  "numeric_base_second_call_abs": again,
                  "numeric_base_later_max_err": later,
                  "numeric_base_later_varied": varied}


def phase_lattice_oracle(dev, cache):
    """12c: the oracle at lattice_summary.py's settings on the card."""
    import numpy as np
    from gpe_tpu_torch.experiments.lattice_summary import lattice_potential_grid
    from gpe_tpu_torch.io import load_bundle
    from gpe_tpu_torch.validate.imaginary_time import imaginary_time_gpe

    spec = load_bundle(os.path.join(LATTICE, "bundle.pkl"))["spec"]
    V, xi, dx = lattice_potential_grid(spec, 255)
    v_err = float(np.abs(V - cache["V"]).max())
    if not (v_err <= LATTICE_V_ATOL and np.allclose(xi, cache["xi"], rtol=0, atol=1e-14)
            and abs(dx - float(cache["dx"])) < 1e-15):
        raise AssertionError(f"lattice_potential_grid against the cache: V {v_err}")
    out, psi = {"V_err": v_err}, None
    for i, g in enumerate(LATTICE_ORACLE_GAMMAS):
        t0 = time.perf_counter()
        mu, psi = imaginary_time_gpe(cache["V"], dx, g, kinetic=float(spec["kinetic"]),
                                     p=float(spec["p"]), tau=2e-3, richardson=2,
                                     bc="dirichlet", psi0=psi, device=dev)
        want = float(cache["mu_refs"][i])
        psi_err = float(np.abs(psi.cpu().numpy() - cache["psis"][i]).max())
        out[str(g)] = {"mu": mu, "abs_err": abs(mu - want), "psi_err": psi_err,
                       "s": time.perf_counter() - t0}
        log(f"12c oracle γ={g}: μ {mu!r} against the committed {want!r}: |Δ| "
            f"{abs(mu - want):.3e}, max |Δψ| {psi_err:.3e}; {out[str(g)]['s']:.2f} s")
        if not abs(mu - want) <= LATTICE_ORACLE_ATOL:
            raise AssertionError(f"lattice oracle γ={g}: {mu} against {want}")
    log(f"12c the port's own V (float32) against the cache's: max |ΔV| {v_err:.3e}")
    return out


def phase_lattice_plpinn(dev, series, lb, ub):
    """12d: the K1/K2 path; returns (its launches, its numbers)."""
    from gpe_tpu_torch.experiments import gpe2d_lattice_plpinn as lp
    from gpe_tpu_torch.kernels import fused_grad as k2
    from gpe_tpu_torch.kernels import fused_residual as k1
    from gpe_tpu_torch.physics.numeric import register_numeric_basis

    out, launches = {}, None
    for label, base in (("numeric base", series), ("planted fault (Δ zeroed)",
                                                   _ZeroLap(series))):
        spec = lp.lattice_spec(register_numeric_basis("lattice_smoke", base), lb, ub)
        k1.collocation_sums.launches = 0
        k2.collocation_grads.launches = 0
        res, _, wall = lp.train(spec, LATTICE_PLPINN["ramp"], [0.0],
                                LATTICE_PLPINN["epochs"], LATTICE_PLPINN["lm_steps"],
                                True, dev, verbose=False)
        counts = {"fused_residual": k1.collocation_sums.launches,
                  "fused_grad": k2.collocation_grads.launches}
        if launches is None:
            launches = counts
        mu_lm = res.polished[0]["by_gamma"][0.0]
        out[label] = {"mu_lm0": mu_lm, "mu_table": res.mu_table[0], "wall_s": wall,
                      "seconds": res.seconds, "launches": counts}
        log(f"12d gpe2d_lattice_plpinn (ramp {LATTICE_PLPINN['ramp']}, "
            f"{LATTICE_PLPINN['epochs']} epochs, {LATTICE_PLPINN['lm_steps']} LM + f64 "
            f"endgame at γ=0), {label}: μ_lm(0) {mu_lm!r}, μ table {res.mu_table[0]}, "
            f"{wall:.2f} s, launches {counts}")
    return launches, out


def phase_lattice(dev):
    """Phase 12 (a)–(e); returns (the K1/K2 rows at the lattice shape, the
    launches of 12d's sound run, of 12c and 12e (all 0), its numbers)."""
    import tempfile

    import numpy as np
    import torch
    from gpe_tpu_torch.experiments import gpe2d_lattice_flagship as lf
    from gpe_tpu_torch.experiments import gpe2d_lattice_plpinn as lp
    from gpe_tpu_torch.experiments import lattice_gamma0_band as band
    from gpe_tpu_torch.io import load_params
    from gpe_tpu_torch.models.mlp import init_mlp, params_from_numpy
    from gpe_tpu_torch.train.pretrain import pretrain_to_base, run_lbfgs
    from gpe_tpu_torch.train.problem import make_batch
    from gpe_tpu_torch.train.spectral_flow import make_spectral_flow_solver

    t_phase = time.perf_counter()
    cache = np.load(os.path.join(LATTICE, "oracle_cache.npz"))
    mu_refs = {float(g): float(m) for g, m in zip(cache["gammas"], cache["mu_refs"])}
    series, lb, ub = lp.lattice_base(cache)
    rows, out = phase_lattice_kernels(dev, series, lb, ub)
    launches, out["plpinn"] = phase_lattice_plpinn(dev, series, lb, ub)
    sound = out["plpinn"]["numeric base"]["mu_lm0"]
    fault = out["plpinn"]["planted fault (Δ zeroed)"]["mu_lm0"]
    if not (abs(sound - mu_refs[0.0]) <= LATTICE_PL_ATOL < abs(fault - mu_refs[0.0])):
        raise AssertionError(f"12d μ_lm(0): {sound}, fault {fault}, against {mu_refs[0.0]}")
    if not (launches["fused_grad"] >= len(LATTICE_PLPINN["ramp"]) * LATTICE_PLPINN["epochs"]
            and launches["fused_residual"] > 0):
        raise AssertionError(f"12d launches {launches}")

    counters = _kernel_counters()
    for _, reset in counters.values():
        reset()
    out["oracle"] = phase_lattice_oracle(dev, cache)
    # 12e: the flagship cut to one γ = 5 rung
    t0 = time.perf_counter()
    run_lbfgs.steps = 0
    spec = lf.flow_spec(lb, ub)
    batch = make_batch(spec, 0, device=dev)
    seed = lf.oracle_seed(cache, lb, ub, batch["x"].cpu().numpy())
    params = init_mlp(spec.layers, generator=torch.Generator().manual_seed(0), device=dev)
    params, pre_mse = pretrain_to_base(params, batch["x"], torch.as_tensor(
        seed, dtype=spec.dtype, device=dev), spec.activation, **FLOW_PRETRAIN)
    r = make_spectral_flow_solver(spec, tau=2e-2, bc="dirichlet", **FLOW_CUT)(
        params, batch, 5.0)
    out["flagship"] = {"s": time.perf_counter() - t0, "pretrain_mse": pre_mse,
                       "mu_net": r.mu, "mu_grid": r.mu_grid, "seconds": r.seconds,
                       "abs_err_net": abs(r.mu - mu_refs[5.0]),
                       "abs_err_grid": abs(r.mu_grid - mu_refs[5.0]),
                       "lbfgs_steps": run_lbfgs.steps}
    log(f"12e gpe2d_lattice_flagship (cut, γ=5): {json.dumps(out['flagship'])}")
    if not (math.isfinite(r.mu) and out["flagship"]["abs_err_grid"] < LATTICE_FLOW_GRID_ATOL):
        raise AssertionError(f"12e flagship (cut): {out['flagship']}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sec = band.stage_net(128, 192, BAND_NET["pretrain_epochs"], BAND_NET["polish_steps"],
                             1.0, read_dir=LATTICE, cache_dir=LATTICE, out_dir=tmp,
                             device=dev)
    out["band_net"] = {"s": time.perf_counter() - t0,
                       **{k: sec[k] for k in ("mu_net", "abs_err_vs_E0_star", "pde_loss",
                                              "distill_mse", "seconds",
                                              "band_projections_after_polish")}}
    log(f"12e lattice_gamma0_band stage_net (cut): {json.dumps(out['band_net'])}")
    projs = sec["band_projections_after_polish"]
    if not (math.isfinite(sec["mu_net"]) and math.isfinite(sec["pde_loss"])
            and len(projs) == 8 and max(map(abs, projs)) < BAND_NET_PROJ):
        raise AssertionError(f"12e band stage_net (cut): {out['band_net']}")
    jparams = params_from_numpy(load_params(os.path.join(LATTICE, "ground_state_params.pkl")),
                                device=dev)
    mu, pde = make_spectral_flow_solver(spec, bc="dirichlet").report(
        jparams, batch, torch.tensor(20.0, device=dev))
    out["jax_params_mu"] = float(mu)
    log(f"12e the JAX lattice flagship's params through report at γ=20: μ {float(mu)!r} "
        f"(pde {float(pde):.3e}), the JAX package on a CPU {LATTICE_FLAGSHIP_MU!r}: |Δ| "
        f"{abs(float(mu) - LATTICE_FLAGSHIP_MU):.3e}")
    if not abs(float(mu) - LATTICE_FLAGSHIP_MU) <= LATTICE_FLAGSHIP_ATOL:
        raise AssertionError(f"JAX lattice params: μ {float(mu)}")
    quiet = {name: read() for name, (read, _) in counters.items()}
    log(f"phase 12 (c, e) launches {quiet}")
    if any(quiet.values()):
        raise AssertionError(f"phase 12 (c, e) launched kernels: {quiet}")
    out["phase_s"] = time.perf_counter() - t_phase
    return rows, launches, quiet, out


# phase 13: the split-step propagator with the grid in slabs over gloo
# ranks on the one card (dynamics/sharded.py, the port of the JAX package's
# dry-run stage 6; gloo's all_to_all_single takes CUDA tensors). float64
# against the single-device `evolve` on the same card at
# tests/test_dynamics_sharded.py's bounds, in its three 2D cases at the
# dynamics driver's grid (256², gpe_dynamics.py --n 256) on two ranks and
# its 3D case at 64³ on four, record_every ∤ steps; float32 at stage 6's
# bounds. A planted fault, the tiles received in reverse rank order
# (mesh_check.reversed_all_to_all), must fail the ψ bound. The times are
# two processes sharing one card: parity, not scaling. One spawn of four
# ranks (a spawn's start-up, 20–55 s on one H100, is most of the phase):
# the 2D cases run on a group of its first two (case_sharded's ranks=).
SHARDED_RANKS, SHARDED_3D_RANKS = 2, 4
SHARDED_PSI_ATOL, SHARDED_OBS_RTOL, SHARDED_OBS_ATOL = 5e-13, 1e-11, 1e-12
SHARDED_F32_ATOL, SHARDED_F32_RTOL = 1e-5, 1e-5
SHARDED_2D = dict(n=256, half=8.0, d=0.5)
SHARDED_3D = dict(n=64, half=6.0, d=0.4)
SHARDED_REPS = 100


def _sharded_grid(n: int, half: float, d: float, dim: int):
    """tests/test_dynamics_sharded.py's grid at n^dim: the harmonic trap and
    a unit-norm Gaussian displaced by d along axis 0 (float64)."""
    import numpy as np
    x = np.linspace(-half, half, n, endpoint=False)
    dx = float(x[1] - x[0])
    X = np.meshgrid(*([x] * dim), indexing="ij")
    V = 0.5 * sum(c ** 2 for c in X)
    psi0 = np.exp(-0.5 * ((X[0] - d) ** 2 + sum(c ** 2 for c in X[1:]))).astype(complex)
    psi0 /= np.sqrt(np.sum(np.abs(psi0) ** 2) * dx ** dim)
    return float(x[0]), dx, V, psi0


def phase_sharded(dev):
    """Phase 13: `evolve_sharded` over SHARDED_RANKS gloo ranks on this card
    at 256² (periodic real and imaginary time, Dirichlet; γ 20, dt 2e-3,
    150 steps, a record every 50) and over SHARDED_3D_RANKS at 64³ (γ 10,
    70 steps, a record every 30) in float64, and at 256² in float32 (γ 5,
    dt 1e-3, 100 steps), each against the single-device `evolve` on the
    card; the planted fault; ms a step of the sharded and the unsharded
    propagator and of a step's two all-to-alls. One spawn of
    SHARDED_3D_RANKS ranks, the 256² cases on its first SHARDED_RANKS.
    Returns (the launches on this path: every kernel 0, in this process and
    on each rank; numbers)."""
    import numpy as np
    import torch
    from gpe_tpu_torch.dynamics import evolve
    from gpe_tpu_torch.experiments.mesh_check import run_cases

    t_phase = time.perf_counter()
    counters = _kernel_counters()
    for _, reset in counters.values():
        reset()
    lb, dx, V, psi0 = _sharded_grid(dim=2, **SHARDED_2D)
    lb3, dx3, V3, psi3 = _sharded_grid(dim=3, **SHARDED_3D)
    inputs = {f"{bc}_{im}": (psi0, V, dx, dict(dt=2e-3, steps=150, gamma=20.0, bc=bc, lb=lb,
                                               imaginary=im, record_every=50))
              for bc, im in (("periodic", False), ("periodic", True), ("dirichlet", False))}
    inputs["f32"] = (psi0.astype(np.complex64), V.astype(np.float32), dx,
                     dict(dt=1e-3, steps=100, gamma=5.0, lb=lb, record_every=50))
    three_d = (psi3, V3, dx3, dict(dt=2e-3, steps=70, gamma=10.0, lb=lb3, record_every=30))
    p0, V0, dx0, kw0 = inputs["periodic_False"]
    # The 3D case first: the ranks outside the 256² cases' group then wait
    # in the creation of the next group, and have exited by the timed case.
    two = dict(ranks=SHARDED_RANKS)
    cases = [("3d", "sharded", dict(psi0=psi3, V=V3, dx=dx3, **three_d[3]))]
    cases += [(k, "sharded", dict(psi0=p, V=v, dx=d, **two, **kw))
              for k, (p, v, d, kw) in inputs.items()]
    cases += [("fault", "sharded", dict(psi0=p0, V=V0, dx=dx0, fault=True, **two, **kw0)),
              ("timed", "sharded", dict(psi0=p0, V=V0, dx=dx0, reps=SHARDED_REPS, **two,
                                        **kw0))]
    t0 = time.perf_counter()
    ranks = run_cases(cases, nprocs=SHARDED_3D_RANKS, backend="gloo")
    spawn_s = time.perf_counter() - t0
    for key in ranks[0]:
        if "/obs_" in key or key.endswith("/psi"):
            if not all(np.array_equal(r[key], ranks[0][key]) for r in ranks[1:] if key in r):
                raise AssertionError(f"13: {key} differs across the ranks")
    inputs["3d"] = three_d
    got = ranks[0]
    errs = {}
    for label, (p, v, d, kw) in inputs.items():
        psi_1, obs_1 = evolve(p, v, d, device=dev, **kw)
        psi_1 = psi_1.cpu().numpy()
        psi_err = float(np.abs(got[f"{label}/psi"] - psi_1).max())
        obs_err = {k: float(np.max(np.abs(got[f"{label}/obs_{k}"] - obs_1[k]))
                            / max(float(np.max(np.abs(obs_1[k]))), 1e-300))
                   for k in ("norm", "energy", "mu", "center", "width_sq")}
        if label == "f32":
            ok = (psi_err <= SHARDED_F32_ATOL and obs_err["mu"] <= SHARDED_F32_RTOL)
        else:
            ok = psi_err <= SHARDED_PSI_ATOL and all(
                np.allclose(got[f"{label}/obs_{k}"], obs_1[k], rtol=SHARDED_OBS_RTOL,
                            atol=SHARDED_OBS_ATOL) for k in obs_err)
        ok = ok and np.allclose(got[f"{label}/obs_t"], obs_1["t"])
        errs[label] = {"psi": psi_err, "obs_rel": obs_err}
        log(f"13 {label}: sharded vs single-device on the card: max|Δψ| {psi_err:.3e}, "
            f"observables max|Δ|/max|value| {json.dumps(obs_err)}, μ(end) {obs_1['mu'][-1]!r}")
        if not ok:
            raise AssertionError(f"13 {label}: sharded propagator disagrees: {errs[label]}")
        if label == "periodic_False":
            fault_err = float(np.abs(got["fault/psi"] - psi_1).max())
    log(f"13 planted fault (tiles in reverse rank order): max|Δψ| {fault_err:.3e} "
        f"against the bound {SHARDED_PSI_ATOL:.0e}")
    if not fault_err > SHARDED_PSI_ATOL:
        raise AssertionError(f"13: the planted fault passed ({fault_err})")
    timed = dict(kw0, steps=SHARDED_REPS, record_every=SHARDED_REPS)
    single_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evolve(p0, V0, dx0, device=dev, **timed)
        torch.cuda.synchronize()
        single_ms.append(1e3 * (time.perf_counter() - t0) / SHARDED_REPS)
    numbers = {"spawn_s": spawn_s, "errors": errs, "fault_psi_err": fault_err,
               "sharded_step_ms": [float(r["timed/step_ms"]) for r in ranks[:SHARDED_RANKS]],
               "a2a_ms": [float(r["timed/a2a_ms"]) for r in ranks[:SHARDED_RANKS]],
               "single_step_ms": single_ms[-1]}
    launches = {name: read() for name, (read, _) in counters.items()}
    for r in ranks:
        for key, v in r.items():
            if "/launches_" in key:
                name = key.split("/launches_")[1]
                launches[name] = launches.get(name, 0) + int(v)
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"13 ms a step at 256² f64, periodic real time: sharded over {SHARDED_RANKS} ranks "
        f"{numbers['sharded_step_ms']} (its two all-to-alls {numbers['a2a_ms']}), "
        f"single-device {single_ms[-1]:.4f}; launches {launches}; phase "
        f"{numbers['phase_s']:.1f} s (its spawn {spawn_s:.1f} s)")
    if any(launches.values()):
        raise AssertionError(f"phase 13 launched kernels: {launches}")
    return launches, numbers


# ---- phase 14: the figures ------------------------------------------------
# The wavefunction gather is f32 forward passes of the same nets on the same
# grid: card against CPU within f32 round-off of |u| ≤ ~1.
FIGURE_GATHER_ATOL = 1e-5
# 11d's drivers, by their directory in its tmp: the figure files and the
# summaries whose records carry `plot`
DRIVER_FIGURES = {"rd": ("rotating_dynamics", ["rotating_dynamics.npz"], ["summary.json"]),
                  "gd": ("gpe_dynamics", ["quench_modes.npz"],
                         ["summary.json", "summary_f32.json"]),
                  "gv": ("gpe2d_vortex", ["vortex_omega0.9.npz"], ["summary.json"])}


def _check_figure_npz(path: str) -> dict:
    """The arrays of one of 11d's figure files, checked finite and shaped
    as its draw function takes them; returns their shapes."""
    import numpy as np

    d = dict(np.load(path))
    for k, v in d.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"14c {path}: {k} is not finite")
    name = os.path.basename(path)
    if name == "rotating_dynamics.npz":
        ok = (d["density"].shape == (128, 128) and d["density"].min() >= 0
              and d["tau_t"].shape == d["lz"].shape == d["n_vortices"].shape
              and d["t"].ndim == 1 and d["t"].shape == d["cx"].shape == d["x_pred"].shape
              and d["lb"].shape == d["omega"].shape == ())
    elif name == "quench_modes.npz":
        ok = (d["t_k"].ndim == 1 and d["t_k"].shape == d["cx"].shape
              and d["t_b"].shape == d["w2"].shape
              and all(d[k].shape == () for k in ("d", "w_dip", "w_br")))
    else:
        ok = (d["psi"].shape == (128, 128) and np.iscomplexobj(d["psi"])
              and float(d["omega"]) == 0.9
              and all(d[k].shape == () for k in ("lb", "ub", "omega")))
    if not ok:
        raise AssertionError(f"14c {path}: shapes {({k: v.shape for k, v in d.items()})}")
    return {k: list(v.shape) for k, v in d.items()}


def phase_figures(dev, tmp):
    """Phase 14 (a)–(d) on the files 11d's drivers left in `tmp`; returns
    (the launches of every kernel over the phase (all 0), its numbers)."""
    import glob

    import numpy as np
    import torch
    from gpe_tpu_torch import viz
    from gpe_tpu_torch.experiments import gpe2d_vortex, gpe_dynamics, rotating_dynamics
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.experiments.run import wavefunctions_from_bundle
    from gpe_tpu_torch.io import load_bundle

    t_phase = time.perf_counter()
    counters = _kernel_counters()
    for _, reset in counters.values():
        reset()
    plots = viz.plots_or_none()
    out = {"matplotlib": plots is not None}
    log(f"14a matplotlib {'imports' if plots else 'does not import'} on this host"
        + ("" if plots else ": the figures' arrays are gathered and saved, none is drawn"))

    # (b) the wavefunction gather, card against CPU
    cfg = EXPERIMENTS["harmonic_quick"]
    bundle = load_bundle(os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                                      "harmonic_quick", "bundle.pkl"))
    t0 = time.perf_counter()
    x_card, u_card = wavefunctions_from_bundle(cfg, bundle, dev)
    card_s = time.perf_counter() - t0
    x_cpu, u_cpu = wavefunctions_from_bundle(cfg, bundle, torch.device("cpu"))
    keys = {m: sorted(v) for m, v in u_card.items()}
    if keys != {m: sorted(v) for m, v in u_cpu.items()}:
        raise AssertionError(f"14b: the gathers' rungs differ: {keys}")
    gap = max(float(np.max(np.abs(u_card[m][g] - u_cpu[m][g])))
              for m in u_card for g in u_card[m])
    x_gap = float(np.max(np.abs(x_card - x_cpu)))
    n_curves = sum(len(v) for v in u_card.values())
    out["gather"] = {"max_abs_du": gap, "max_abs_dx": x_gap, "curves": n_curves,
                     "points": int(x_card.size), "card_s": card_s}
    log(f"14b wavefunction gather of runs/harmonic_quick/bundle.pkl ({n_curves} curves at "
        f"{x_card.size} points, modes {sorted(keys)}): card vs CPU max|Δu| {gap:.3e} "
        f"(bound {FIGURE_GATHER_ATOL:.0e}), max|Δx| {x_gap:.3e}; {card_s:.2f} s on the card")
    if not (gap <= FIGURE_GATHER_ATOL and x_gap <= FIGURE_GATHER_ATOL
            and all(np.all(np.isfinite(u)) for v in u_card.values() for u in v.values())):
        raise AssertionError(f"14b: the wavefunction gather leaves the CPU: {out['gather']}")

    # (c) 11d's figure files and records
    out["npz"] = {}
    for sub, (driver, files, summaries) in DRIVER_FIGURES.items():
        for f in files:
            path = os.path.join(tmp, sub, f)
            if not os.path.exists(path):
                raise AssertionError(f"14c: {driver} left no {f}")
            out["npz"][f] = _check_figure_npz(path)
        for sname in summaries:
            rec = json.load(open(os.path.join(tmp, sub, sname)))
            plot = rec["results"][0]["plot"] if driver == "gpe2d_vortex" else rec["plot"]
            want = ([f[:-len(".npz")] + ".png" for f in files] if plots else
                    viz.not_written(f"python -m gpe_tpu_torch.experiments.{driver} "
                                    f"--plots --out {tmp}/{sub}"))
            if plot != want:
                raise AssertionError(f"14c: {driver} {sname} plot {plot!r}, want {want!r}")
    log(f"14c the drivers' figure files (finite, shaped for their draw functions): "
        f"{json.dumps(out['npz'])}; each record's plot "
        + ("lists its PNG" if plots else "names --plots (no matplotlib here)"))

    # (d) the drivers' --plots from those files
    if plots:
        for sub, mod in (("rd", rotating_dynamics), ("gd", gpe_dynamics), ("gv", gpe2d_vortex)):
            for png in glob.glob(os.path.join(tmp, sub, "*.png")):
                os.remove(png)
            mod.main(["--plots", "--out", os.path.join(tmp, sub)])
            for f in DRIVER_FIGURES[sub][1]:
                png = os.path.join(tmp, sub, f[:-len(".npz")] + ".png")
                if not (os.path.exists(png) and os.path.getsize(png) > 0):
                    raise AssertionError(f"14d: {png} was not drawn")
        log("14d each driver's --plots drew its PNG from its .npz")
    else:
        log("14d skipped: matplotlib does not import here, so nothing is drawn")
    launches = {name: read() for name, (read, _) in counters.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"14 launches {launches}; phase {out['phase_s']:.2f} s")
    if any(launches.values()):
        raise AssertionError(f"phase 14 launched kernels: {launches}")
    return launches, out


def phase_reports():
    """Phase 15: the report scripts on the committed runs/ (host only);
    returns (the launches of every kernel over the phase (all 0), its
    numbers)."""
    from gpe_tpu_torch.experiments import report_check

    t_phase = time.perf_counter()
    counters = _kernel_counters()
    for _, reset in counters.values():
        reset()
    runs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs")
    out = report_check.check_committed(runs)
    parity, anchor = out["parity"], out["gamma0_anchor"]
    log(f"15 reports on the committed runs/: parity.md \"ours\" cells {parity['equal']} "
        f"of {parity['rows']} rows equal (whole file equal: {parity['identical']}); "
        f"gamma0_anchor.md {anchor['equal']} of {anchor['rows']}, differing "
        f"{json.dumps(anchor['differ'])}; only the stale row differs: {out['ok']}")
    if not out["ok"] or parity["rows"] != 33 or anchor["rows"] != 33:
        raise AssertionError(f"15 the reports against the committed tables: {out}")
    launches = {name: read() for name, (read, _) in counters.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"15 launches {launches}; phase {out['phase_s']:.2f} s")
    if any(launches.values()):
        raise AssertionError(f"phase 15 launched kernels: {launches}")
    return launches, out


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
    t_main = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from gpe_tpu_torch.device import pin_full_f32
    pin_full_f32()

    phase_env()
    cfg, spec, batch, params = main_shape(dev)
    kernels = [phase_k1(spec, batch, params), phase_k2(spec, batch, params)]
    del batch, params
    launches, steps, run_s = phase_main_path(cfg, dev)
    rcfg, rspec, rbatch, rparams, gammas, scales = runs_shape(dev)
    kernels += [phase_k3_sums(rspec, rbatch, rparams, gammas, scales),
                phase_k3_grads(rspec, rbatch, rparams, gammas, scales)]
    del rbatch, rparams
    packed_launches, packed_steps = phase_packed_path(rcfg, dev)
    launches.update(packed_launches)
    steps.update(packed_steps)
    bspec, bbatch, bparams = bench_shape(dev)
    phase_width100(bspec, bbatch, bparams)
    kernels.append(phase_k4(bspec, bbatch, bparams, "bench shape"))
    main = main_shape(dev)[1:]
    k4_main = phase_k4(*main, "main shape")
    kernels[-1].update(main_shape_ms=k4_main["ms"],
                       main_shape_bound_ms=k4_main["bound_ms"])
    kernels += phase_bf16(bspec, bbatch, bparams, main)
    del main
    del bbatch, bparams
    phase_dynamics(dev)
    bench_launches = phase_bench(dev)
    launches.update({k: bench_launches[k] for k in
                     ("rowcat_eval", "fused_residual_bf16", "rowcat_eval_bf16")})
    oracle_s = phase_oracle(dev)
    polished, pbatch, pscale, pgamma = phase_bundle(cfg, dev)
    x64_s = phase_polish_x64(cfg.spec, polished, pbatch, pscale, pgamma)
    del polished, pbatch
    phases = {}
    t0 = time.perf_counter()
    cross_launches, cross_steps = phase_cross_potential(dev)
    phases["cross_potential"] = time.perf_counter() - t0
    steps.update(cross_steps)
    t0 = time.perf_counter()
    gw_launches, _ = phase_gravity_packed(dev)
    phases["gravity_well_packed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_cross_bundles(dev)
    phases["cross_bundles"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_fit_circle(dev)
    phases["fit_circle"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ens_k3, ens_rows = phase_fit_ensemble(dev)
    phases["fit_ensemble"] = time.perf_counter() - t0
    counter = _runs_counters()
    for fn in counter.kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    config_launches, config_s = phase_compare_configs(dev)
    phases["compare_configs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    family = phase_run_family(dev)
    phases["run_family"] = time.perf_counter() - t0
    comparison = {k: fn.launches for k, fn in counter.kernels.items()}
    log(f"comparison path launches {comparison}; configs {json.dumps(config_launches)}")
    t0 = time.perf_counter()
    sweep_launches, sweep = phase_beta_sweep(dev)
    phases["beta_sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer_launches, trainer_s = phase_trainer_configs(dev)
    phases["trainer_configs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    psum_row, mesh = phase_mesh(dev)
    phases["mesh"] = time.perf_counter() - t0
    kernels.append(psum_row)
    t0 = time.perf_counter()
    zoo_launches, zoo = phase_zoo(dev)
    phases["zoo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d3_rows, flow_launches, plpinn3d_launches, flow = phase_flow(dev)
    phases["flow"] = time.perf_counter() - t0
    for row in d3_rows:
        row["launches_by_path"] = {"plpinn_3d": row["launches"]}
    kernels += d3_rows
    import tempfile

    # 11d's drivers write their figure files here; phase 14 reads them
    drivers_tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    bf16_rows, bf16_fit_launches, rotating_launches, rotating = phase_rotating(
        dev, drivers_tmp.name)
    phases["rotating"] = time.perf_counter() - t0
    for row in bf16_rows:
        row["launches"] = bf16_fit_launches[row["name"]]
        row["launches_by_path"] = {"bf16_fits": row["launches"]}
    kernels += bf16_rows
    t0 = time.perf_counter()
    lattice_rows, lattice_launches, lattice_quiet, lattice = phase_lattice(dev)
    phases["lattice"] = time.perf_counter() - t0
    for row in lattice_rows:
        row["launches"] = lattice_launches[row["name"][:-len("_lattice")]]
        row["launches_by_path"] = {"lattice": row["launches"]}
    kernels += lattice_rows
    t0 = time.perf_counter()
    sharded_launches, sharded = phase_sharded(dev)
    phases["sharded"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    figures_launches, figures = phase_figures(dev, drivers_tmp.name)
    phases["figures"] = time.perf_counter() - t0
    drivers_tmp.cleanup()
    t0 = time.perf_counter()
    reports_launches, reports = phase_reports()
    phases["reports"] = time.perf_counter() - t0
    by_path = {"cross_potential": cross_launches, "gravity_well_packed": gw_launches,
               "comparison": comparison, "beta_sweep": sweep_launches,
               "trainer_configs": trainer_launches,
               "zoo_curriculum_helmholtz": zoo_launches,
               "deeponet_flagships_sngd": flow_launches, "plpinn_3d": plpinn3d_launches,
               "rotating_dynamics_drivers": rotating_launches,
               "lattice_oracle_drivers": lattice_quiet,
               "sharded_dynamics": sharded_launches, "figures": figures_launches,
               "reports": reports_launches}
    for k in kernels:
        if "launches" not in k:
            k["launches"] = launches[k["name"]]
        for path, counts in by_path.items():
            if k["name"] in counts:
                k.setdefault("launches_by_path", {})[path] = counts[k["name"]]
        if k["name"] in ("fused_residual_runs", "fused_grad_runs"):
            k["fit_ensemble"] = {label: v[k["name"]] for label, v in ens_k3.items()}
    log(json.dumps({"steps_ms": steps, "oracle_s": oracle_s, "polish_x64_s": x64_s,
                    "run_main_s": run_s, "families_phase_s": phases,
                    "fit_ensemble": ens_rows, "compare_configs_s": config_s,
                    "run_family": {k: family[k] for k in ("wall_s", "seconds",
                                                          "launches")},
                    "beta_sweep": sweep, "trainer_configs_s": trainer_s,
                    "mesh": mesh, "zoo": zoo, "flow": flow, "rotating": rotating,
                    "lattice": lattice, "sharded": sharded, "figures": figures,
                    "reports": reports},
                   default=str))
    check_no_children()
    log(f"chip_smoke.py phases 1-15: {time.perf_counter() - t_main:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
