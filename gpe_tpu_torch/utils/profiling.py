"""Tracing and throughput measurement, port of `gpe_tpu/utils/profiling.py`:
a timer that waits for the CUDA device at its edges, the collocation
points/s/device meter, and a `torch.profiler` trace context."""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


def _sync() -> None:
    """Wait for the CUDA device's queued work (a no-op where CUDA was never
    started, so a CPU run does not start it)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall-clock timer whose edges wait for queued device work, so the time
    is the work's and not its launch's."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed = time.perf_counter() - self._t0
        return False


def throughput_meter(fn, args, n_points: int, warmup: int = 3, iters: int = 20):
    """Collocation points/s (and per CUDA device) of fn(*args), whose cost
    scales with n_points; waits for the device after the warmup and after
    the timed calls."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    dt = (time.perf_counter() - t0) / iters
    n_devices = max(torch.cuda.device_count(), 1)
    return {"pts_per_sec": n_points / dt, "pts_per_sec_per_chip": n_points / dt / n_devices,
            "sec_per_iter": dt}


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """`torch.profiler` over the scope (CPU, and CUDA where there is a card);
    on exit the Chrome/Perfetto trace is written to `log_dir`/trace.json
    (default: gpe_tpu_torch_trace in the temporary directory)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "gpe_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
