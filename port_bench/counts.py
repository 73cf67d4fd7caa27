"""Operations and bytes of the measured work, counted from shapes alone.

These counts are the benchmark's yardstick: they say what the algorithm
needs at a cell's shapes, whatever implements it, so a later change to a
kernel or to the solver cannot move them.

`matmul_flops` is copied from `gpe_tpu_torch/bench.py:matmul_flops` (the
port's count of the fused kernels' GEMM work); the rest is new.
"""
from __future__ import annotations


def matmul_flops(layers, n: int, grad: bool) -> float:
    """Multiply-add FLOPs (2 a multiply-add) of the forward-Laplacian MLP
    on n points, GEMMs only (the elementwise and transcendental work is left
    out, so a bound from it is a lower bound). C = d+2 channel rows a point;
    layer 0 multiplies the value channel only; the last layer is a
    (C x K) x (K x 1) product. grad=True adds, per hidden GEMM layer, the W̄
    and the backprop GEMMs, and the last layer's W̄ (value and Laplacian
    rows) and layer 0's W̄: the fused value-and-grad (K2)."""
    d = layers[0]
    C = d + 2
    hidden = list(zip(layers[1:-2], layers[2:-1]))
    per_pt = 2 * d * layers[1] + sum(2 * C * k * m for k, m in hidden) \
        + 2 * C * layers[-2]
    if grad:
        per_pt += sum(4 * C * k * m for k, m in hidden) + 4 * layers[-2] \
            + 2 * (d + 1) * layers[1]
    return float(per_pt) * n


def value_flops(layers, n: int) -> float:
    """Multiply-add FLOPs of the plain forward (value only) on n points."""
    return float(sum(2 * k * m for k, m in zip(layers[:-1], layers[1:]))) * n


def n_params(layers) -> int:
    return sum(k * m + m for k, m in zip(layers[:-1], layers[1:]))


def k2_bytes(layers, n: int) -> float:
    """Bytes one launch of the fused value-and-grad must move at least: each
    input read once (x as (n, d), V, w, base value and base Laplacian as
    (n,), the parameters) and each output written once (the gradient and
    the four sums), all float32."""
    d = layers[0]
    P = n_params(layers)
    return 4.0 * (n * (d + 4) + P + P + 4)


def lm_forward_flops(layers, n: int, n_boundary: int) -> float:
    """GEMM FLOPs of one evaluation of the LM residual: the forward-Laplacian
    forward on the n collocation points and the value forward on the
    boundary probes."""
    return matmul_flops(layers, n, grad=False) + value_flops(layers, n_boundary)


def lm_step_flops(layers, n: int, n_boundary: int, cg_iters: float) -> float:
    """GEMM FLOPs one LM step needs: each CG matvec JᵀJv is 4 residual
    forwards (the jvp's primal and tangent, the vjp's backward as two), and
    the step's own gradient vjp, curvature jvp and trial residual add 6."""
    return (4.0 * cg_iters + 6.0) * lm_forward_flops(layers, n, n_boundary)
