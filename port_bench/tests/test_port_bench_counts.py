"""The benchmark's operation and byte counts against counts by hand."""
import pytest

from port_bench import counts


def test_matmul_flops_by_hand():
    # d = 1, widths 3, 2: C = 3 channel rows; layer 0 multiplies the value
    # row only (2·1·3), the hidden GEMM all three rows (2·3·3·2), the last
    # layer (2·3·2)
    fwd = 2 * 1 * 3 + 2 * 3 * 3 * 2 + 2 * 3 * 2
    assert counts.matmul_flops((1, 3, 2, 1), 5, grad=False) == 5 * fwd
    # the gradient adds the hidden layer's W̄ and backprop (4·3·3·2), the
    # last layer's W̄ on the value and Laplacian rows (4·2), layer 0's W̄
    # (2·(d+1)·3)
    grad = 4 * 3 * 3 * 2 + 4 * 2 + 2 * 2 * 3
    assert counts.matmul_flops((1, 3, 2, 1), 5, grad=True) == 5 * (fwd + grad)


def test_main_shape_flops_match_the_recorded_bound():
    # PERF.md's K2 bound at 50,176 points: 0.2400 ms at 165 TFLOP/s
    f = counts.matmul_flops((2, 128, 128, 128, 1), 50176, grad=True)
    assert f / (495e12 / 3) * 1e3 == pytest.approx(0.2400, abs=5e-5)


def test_bytes_and_params_by_hand():
    assert counts.n_params((2, 3, 1)) == 2 * 3 + 3 + 3 + 1
    P = 13
    # x (n·2), V, w, base value, base Laplacian, params in; grads, 4 sums out
    assert counts.k2_bytes((2, 3, 1), 10) == 4 * (10 * 6 + P + P + 4)


def test_lm_step_flops_by_hand():
    f = counts.lm_forward_flops((2, 3, 1), 10, 4)
    assert f == counts.matmul_flops((2, 3, 1), 10, False) + 4 * (2 * 2 * 3 + 2 * 3 * 1)
    assert counts.lm_step_flops((2, 3, 1), 10, 4, 7) == (4 * 7 + 6) * f
