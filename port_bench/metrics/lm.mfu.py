"""The LM step's GEMM FLOPs over its wall time, against the f32-parity
peak: (4 × CG matvecs + 6) residual forwards a step (port_bench/counts.py),
the matvecs a step read from the profiled call's graph launches, the time
from the window's unprofiled calls."""
from port_bench.counts import lm_step_flops

PEAK = 495e12 / 3        # FLOP/s: dense TF32 / 3 (3xTF32), H100 SXM


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "lm" or tr is None:
        return None
    traced = [c for c in rec["calls"] if c["traced"]]
    calls = [c for c in rec["calls"] if not c["traced"]]
    steps = sum(c["steps"] for c in calls)
    if not steps:
        return None
    cg = tr.graph_launches() / sum(c["steps"] for c in traced)
    step_s = sum(c["wall_s"] for c in calls) / steps
    flops = lm_step_flops(rec["layers"], rec["n_points"], rec["n_boundary"], cg)
    return 100.0 * flops / step_s / PEAK
