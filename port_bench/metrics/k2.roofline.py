"""K2's device time per launch against its bound, in %.

The bound is the larger of its GEMM FLOPs at the f32-parity peak and its
bytes at the HBM bandwidth (port_bench/counts.py). The time is the
profiled rung's device time in the kernels of csrc/fused_grad.cu — the
layout kernel `gpe::pad_weights`, the gradient kernel `gpe::grads_kernel`
and the `gpe::reduce_partials` that follows each gradient kernel (K1 runs
the same reduction after its own kernel) — over the K2 launches that the
port's launch counter counted in that rung."""
from port_bench.counts import k2_bytes, matmul_flops

PEAK = 495e12 / 3        # FLOP/s: dense TF32 / 3 (3xTF32), H100 SXM
HBM = 3.35e12            # bytes/s, H100 SXM data sheet


def k2_us(device) -> float:
    total, last = 0.0, None
    for name, s, e in sorted(device, key=lambda t: t[1]):
        if "gpe::grads_kernel" in name or "gpe::pad_weights" in name:
            total += e - s
        elif "gpe::reduce_partials" in name and last is not None \
                and "gpe::grads_kernel" in last:
            total += e - s
        if "gpe::" in name:
            last = name
    return total


def read(rec):
    tr = rec.get("trace")
    if rec["kind"] != "fit" or tr is None:
        return None
    launches = sum(r["launches"]["fused_grad"] for r in rec["rungs"] if r["traced"])
    us = k2_us(tr.device)
    if launches == 0 or us <= 0:
        return None
    n, layers = rec["n_points"], rec["layers"]
    bound_s = max(matmul_flops(layers, n, grad=True) / PEAK, k2_bytes(layers, n) / HBM)
    return 100.0 * bound_s / (us * 1e-6 / launches)
