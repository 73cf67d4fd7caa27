"""The fit step's GEMM FLOPs (the fused value-and-grad's, counted from the
shapes by port_bench/counts.py) × steps over the wall time of the window's
unprofiled rungs, against the card's f32-parity peak."""
from port_bench.counts import matmul_flops

# f32-parity products: dense TF32 (495 TFLOP/s, H100 SXM data sheet) over
# the three TF32 products of one 3xTF32 product, as gpe_tpu_torch/bench.py's
# PEAK_FLOPS["tf32x3"] has it.
PEAK = 495e12 / 3


def read(rec):
    if rec["kind"] != "fit":
        return None
    rungs = [r for r in rec["rungs"] if not r["traced"]]
    wall = sum(r["wall_s"] for r in rungs)
    if wall <= 0:
        return None
    flops = matmul_flops(rec["layers"], rec["n_points"], grad=True)
    return 100.0 * flops * sum(r["steps"] for r in rungs) / wall / PEAK
