"""Where a fused training step's (or a fused eval's) time goes on the card.

    python -m gpe_tpu_torch.experiments.profile_step [--steps 100]

Three steps: at the `gpe2d_ground_state` main shape (50,176 points,
[2,128,128,128,1]) the default relaxed step and the exact two-kernel step
of `fit`; at the `harmonic_paper` packed shape (six runs, modes 0–5, of
[1,64,64,64,1] on 4,000 points) the exact run-mode step of
`fit_ensemble_packed`. Then two evals at the benchmark's shape
(`gpe_tpu_torch.bench`: 50,176 points, [2,100,100,100,1], γ = 100): the
full loss on K1 and on K4. For each: the time per step (or eval) from CUDA
events, then the same work under torch.profiler, summing the device time of
every kernel by name. The device-busy share is kernel time per step over
the un-profiled step time. Prints one JSON line per step. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from collections import defaultdict

import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.experiments.configs import EXPERIMENTS
from gpe_tpu_torch.models.mlp import init_mlp, stack_runs
from gpe_tpu_torch.train.loop import fit
from gpe_tpu_torch.train.packed import fit_ensemble_packed
from gpe_tpu_torch.train.plpinn import ramp_optimizer
from gpe_tpu_torch.train.problem import (make_batch, make_fused_value_and_grad,
                                         make_loss_fn)


def _kernel_times(prof) -> dict:
    """Device microseconds per kernel name over the profiled window."""
    out = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] += e.time_range.elapsed_us()
    return out


def _profile(name: str, run, steps: int) -> dict:
    """run(n) trains n steps; returns its step time and kernel breakdown."""
    run(10)                                            # build + warm up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(steps)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / steps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    kt = _kernel_times(prof)
    busy_ms = sum(kt.values()) / 1e3 / steps
    top = sorted(kt.items(), key=lambda kv: -kv[1])[:8]
    return {"mode": name, "steps": steps,
            "step_ms": step_ms, "kernel_ms_per_step": busy_ms,
            "device_busy_share": busy_ms / step_ms,
            "kernel_launches_per_step": sum(
                1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA) / steps,
            "top_kernels_ms_per_step": [(name[:60], us / 1e3 / steps)
                                        for name, us in top]}


def profile_mode(relaxed: bool, steps: int, dev) -> dict:
    cfg = EXPERIMENTS["gpe2d_ground_state"]
    spec = cfg.spec
    batch = make_batch(spec, 0, device=dev)
    params = init_mlp(spec.layers, generator=torch.Generator().manual_seed(0),
                      device=dev)
    loss_fn = make_loss_fn(spec)
    vag = make_fused_value_and_grad(spec, device=dev, relaxed=relaxed)
    run = lambda n: fit(loss_fn, ramp_optimizer(cfg.lr), params, batch, 5.0,
                        0.01, epochs=n, tol=-1.0, patience=10 ** 9,
                        check_every=n, value_and_grad_fn=vag)
    return _profile("relaxed" if relaxed else "exact", run, steps)


def profile_packed(steps: int, dev) -> dict:
    """The exact run-mode step of the six-mode harmonic_paper ensemble."""
    cfg = EXPERIMENTS["harmonic_paper"]
    spec, modes = cfg.spec, cfg.modes
    batch = make_batch(spec, modes[0], device=dev)
    per_mode = [make_batch(spec, m, device=dev) for m in modes]
    prb = {k: torch.stack([b[k] for b in per_mode])
           for k in ("base_val", "base_lap", "base_bval")}
    params = stack_runs([init_mlp(spec.layers, generator=torch.Generator().manual_seed(r),
                                  device=dev) for r in range(len(modes))])
    run = lambda n: fit_ensemble_packed(spec, params, batch, 1.0, 0.01, epochs=n,
                                        tol=-1.0, patience=10 ** 9, check_every=n,
                                        lr=cfg.lr, lr_mode="loss_faithful",
                                        per_run_base=prb)
    return _profile(f"packed_exact_{len(modes)}_runs", run, steps)


def profile_eval(kernel: str, steps: int, dev) -> dict:
    """One full-loss eval of the benchmark on K1 ("k1") or K4 ("k4")."""
    from gpe_tpu_torch import bench
    from gpe_tpu_torch.kernels.fused_residual import make_loss_eval
    from gpe_tpu_torch.kernels.rowcat_eval import make_rowcat_loss_eval

    spec = bench.bench_spec()
    batch = make_batch(spec, 0, device=dev)
    params = init_mlp(spec.layers, generator=torch.Generator().manual_seed(0),
                      device=dev)
    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity, bc_weight=spec.bc_weight,
              norm_weight=spec.norm_weight)
    ev = (make_loss_eval(spec.layers, **kw) if kernel == "k1"
          else make_rowcat_loss_eval(spec.layers, **kw))

    def run(n):
        for _ in range(n):
            ev(params, batch, bench.GAMMA, bench.SCALE)
    return _profile(f"bench_eval_{kernel}", run, steps)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    dev = resolve_device()
    pin_full_f32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for relaxed in (True, False):
        print(json.dumps(profile_mode(relaxed, args.steps, dev)), flush=True)
    print(json.dumps(profile_packed(args.steps, dev)), flush=True)
    for kernel in ("k1", "k4"):
        print(json.dumps(profile_eval(kernel, args.steps, dev)), flush=True)


if __name__ == "__main__":
    main()
