"""Where a fused training step's time goes on the card.

    python -m gpe_tpu_torch.experiments.profile_step [--steps 100]

Three steps: at the `gpe2d_ground_state` main shape (50,176 points,
[2,128,128,128,1]) the default relaxed step and the exact two-kernel step
of `fit`; at the `harmonic_paper` packed shape (six runs, modes 0–5, of
[1,64,64,64,1] on 4,000 points) the exact run-mode step of
`fit_ensemble_packed`. For each: the step time from CUDA events around the
fit, then the same steps under torch.profiler, summing the device time of
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


if __name__ == "__main__":
    main()
