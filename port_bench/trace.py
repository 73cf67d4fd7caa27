"""Reading a torch.profiler trace of part of a window.

The arithmetic follows `gpe_tpu_torch/experiments/profile_step.py`
(`_kernel_times`: device time summed by kernel name; the busy share over the
profiled span), copied here so that the yardstick stays with the benchmark,
and adds the union of the device's busy intervals, the host's launch calls
and the idle gaps labelled by what the host was doing.

A `Trace` holds plain tuples, so the readers in `metrics/` and the tests
need no profiler: (name, start_us, end_us) for every device activity
(kernels, copies, sets) and for every CUDA runtime call of the host.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

# CUDA runtime and driver calls that put work on the device: a kernel or a
# whole captured graph.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
GRAPH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


@dataclass
class Trace:
    device: list = field(default_factory=list)     # (name, start_us, end_us)
    runtime: list = field(default_factory=list)    # (name, start_us, end_us)

    # --- device ---------------------------------------------------------
    def span_us(self) -> float:
        """From the first to the last event of either side."""
        ev = self.device + self.runtime
        if not ev:
            return 0.0
        return max(e[2] for e in ev) - min(e[1] for e in ev)

    def busy_us(self) -> float:
        """Length of the union of the device's activity intervals."""
        total, end = 0.0, -float("inf")
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total

    def idle_share(self) -> float | None:
        span = self.span_us()
        return None if span <= 0 else 1.0 - self.busy_us() / span

    def device_us(self, match) -> float:
        """Device time of the activities whose name `match` accepts."""
        return sum(e - s for n, s, e in self.device if match(n))

    def by_name(self) -> dict:
        out = defaultdict(float)
        for n, s, e in self.device:
            out[n] += e - s
        return dict(out)

    # --- host -----------------------------------------------------------
    def count_calls(self, names) -> int:
        return sum(1 for n, _, _ in self.runtime if n.startswith(names))

    def launch_calls(self) -> int:
        return self.count_calls(LAUNCH_CALLS + GRAPH_CALLS)

    def graph_launches(self) -> int:
        return self.count_calls(GRAPH_CALLS)

    def idle_gaps(self) -> dict:
        """Seconds of device idleness, by the runtime call the host was in
        for most of each gap ("host" where it was in none: Python)."""
        dev = sorted(self.device, key=lambda t: t[1])
        rt = sorted(self.runtime, key=lambda t: t[1])
        out = defaultdict(float)
        end, j = None, 0
        for _, s, e in dev:
            if end is not None and s > end:
                while j < len(rt) and rt[j][2] <= end:
                    j += 1
                best, cover = "host", 0.0
                k = j
                while k < len(rt) and rt[k][1] < s:
                    c = min(rt[k][2], s) - max(rt[k][1], end)
                    if c > cover:
                        best, cover = rt[k][0], c
                    k += 1
                out[best] += (s - end) * 1e-6
            end = e if end is None else max(end, e)
        return dict(out)


def _short(name: str) -> str:
    """A kernel's name without its argument list."""
    return name.split("(")[0][:120]


def from_profiler(prof) -> Trace:
    """A Trace of a finished torch.profiler.profile."""
    import torch

    tr = Trace()
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        s = e.time_range.start
        t = e.time_range.end
        if e.device_type == cuda:
            tr.device.append((_short(e.name), s, t))
        elif e.name.startswith(("cuda", "cu")):
            tr.runtime.append((e.name, s, t))
    return tr


def profiled(fn):
    """(fn(), Trace of it): the CUDA activity only (device work and runtime
    calls), synchronised at both ends."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, from_profiler(prof)


def breakdown(tr: Trace) -> dict:
    """The `breakdown` of a result line: the ten device operations that
    took most time and the ten largest idle-gap totals, in seconds."""
    ops = sorted(tr.by_name().items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.idle_gaps().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, us * 1e-6] for n, us in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
