"""Where a fused training step's time goes on the card.

    python -m gpe_tpu_torch.experiments.profile_step [--steps 100]

At the `gpe2d_ground_state` main shape (50,176 points, [2,128,128,128,1]),
for the default relaxed step and the exact two-kernel step: the step time
from CUDA events around `fit`, then the same steps under torch.profiler,
summing the device time of every kernel by name. The device-busy share is
kernel time per step over the un-profiled step time. Prints one JSON line
per mode. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from collections import defaultdict

import torch

from gpe_tpu_torch.device import pin_full_f32, resolve_device
from gpe_tpu_torch.experiments.configs import EXPERIMENTS
from gpe_tpu_torch.models.mlp import init_mlp
from gpe_tpu_torch.train.loop import fit
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
    return {"mode": "relaxed" if relaxed else "exact", "steps": steps,
            "step_ms": step_ms, "kernel_ms_per_step": busy_ms,
            "device_busy_share": busy_ms / step_ms,
            "kernel_launches_per_step": sum(
                1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA) / steps,
            "top_kernels_ms_per_step": [(name[:60], us / 1e3 / steps)
                                        for name, us in top]}


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


if __name__ == "__main__":
    main()
