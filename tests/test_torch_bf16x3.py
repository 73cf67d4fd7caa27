"""The three-term bf16 split of an f32 weight (`kernels/fused_grad.py:
split_bf16x3`, the CPU twin of common.cuh's `split_bf16x3`), on which K2's
bf16 operand mode runs its forward and backprop products: bf16(x)·w as
bf16(x)·hi + bf16(x)·mid + bf16(x)·lo on bf16 tensor cores.

- hi + mid + lo reconstructs the f32 weight exactly (xavier draws, x4,
  powers of two, bf16 ties, tiny magnitudes, random bit patterns);
- each product of a bf16 value by a term is exact in f32 (checked in f64);
- a GEMM emulated as the card issues it (per k16 slab lo, then mid, then
  hi, each slab's exact product sum added to an f32 accumulator) meets the
  f64 product sum to f32 round-off, GEMM_ULPS = 4 units of 2^-24 relative
  to Σ|a||b| per entry — it reads 1.5–2.0 on these inputs, a plain f32
  GEMM (numpy or JAX) 3.5–4.4 — and meets JAX's bf16 × f32 product
  (promoted to f32, the JAX kernel's operands) to twice that (3.5–5.1);
- with two terms (lo dropped) the same GEMM reads 25–35 units, with one
  term (hi only, the f32 weight rounded to bf16) 1.5e4–2.3e4: both fail
  four times the bound.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from gpe_tpu_torch.kernels.fused_grad import split_bf16x3  # noqa: E402

U = 2.0 ** -24          # f32 unit round-off
GEMM_ULPS = 4.0


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().astype(np.float64)


def _bits(b: np.ndarray) -> np.ndarray:
    return b.astype(np.uint32).view(np.float32)


def _weights(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind in ("xavier", "xavier_x4"):
        w = rng.normal(0.0, 1.0 / np.sqrt(128), 128 * 128)
        return (w * (4.0 if kind == "xavier_x4" else 1.0)).astype(np.float32)
    if kind == "powers_of_two":
        e = np.arange(-100, 101, dtype=np.float64)
        return np.concatenate([2.0 ** e, -(2.0 ** e)]).astype(np.float32)
    if kind == "bf16_ties":
        # bf16 values (low 16 bits zero) plus a half unit of the last place
        # at the first or the second level, or both: round-half-even cases
        top = rng.integers(0x3000, 0x4800, 4096, dtype=np.uint32) << 16
        top |= rng.integers(0, 2, 4096, dtype=np.uint32) << 31
        low = np.array([0x8000, 0x0080, 0x8080, 0x7F80, 0x80FF, 0xFF80],
                       dtype=np.uint32)[rng.integers(0, 6, 4096)]
        return _bits(top | low)
    if kind == "tiny":
        # |w| from 2^-108 to 2^-80, every significand bit random
        e = rng.integers(127 - 108, 127 - 80, 4096, dtype=np.uint32)
        return _bits((rng.integers(0, 2, 4096, dtype=np.uint32) << 31) | (e << 23)
                     | rng.integers(0, 1 << 23, 4096, dtype=np.uint32))
    if kind == "random_bits":
        e = rng.integers(127 - 100, 127 + 100, 8192, dtype=np.uint32)
        return _bits((rng.integers(0, 2, 8192, dtype=np.uint32) << 31) | (e << 23)
                     | rng.integers(0, 1 << 23, 8192, dtype=np.uint32))
    raise ValueError(kind)


KINDS = ["xavier", "xavier_x4", "powers_of_two", "bf16_ties", "tiny", "random_bits"]


@pytest.mark.parametrize("kind", KINDS)
def test_three_terms_reconstruct_the_f32_weight_exactly(kind):
    w = _weights(kind)
    hi, mid, lo = split_bf16x3(torch.from_numpy(w))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = _f64(hi) + _f64(mid) + _f64(lo)
    np.testing.assert_array_equal(total, w.astype(np.float64))
    # the terms shrink: |mid| ≤ 2^-8|hi|, |lo| ≤ 2^-8|mid| (half an ulp of each)
    assert np.all(np.abs(_f64(mid)) <= 2.0 ** -8 * np.abs(_f64(hi)))
    assert np.all(np.abs(_f64(lo)) <= 2.0 ** -8 * np.abs(_f64(mid)))
    if kind == "powers_of_two":
        assert not _f64(mid).any() and not _f64(lo).any()


@pytest.mark.parametrize("kind", ["xavier", "xavier_x4", "bf16_ties"])
def test_each_bf16_product_with_a_term_is_exact_in_f32(kind):
    w = _weights(kind)
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.normal(0.0, 2.0, w.size).astype(np.float32)) \
        .to(torch.bfloat16).float().numpy()
    for term in split_bf16x3(torch.from_numpy(w)):
        t = term.float().numpy()
        np.testing.assert_array_equal((a * t).astype(np.float64),
                                      a.astype(np.float64) * t.astype(np.float64))


def emulated_gemm(A: np.ndarray, B: np.ndarray, terms: int = 3, slab: int = 16):
    """C = Aᵀ·B (A: (P, rows) f32 weights, B: (P, cols) bf16 values) as the
    card's routine issues it: per k16 slab the terms smallest first (lo,
    mid, hi; `terms` < 3 drops the small ones), each slab's product sum
    exact (every product is) and added once to an f32 accumulator."""
    parts = [_f64(t) for t in split_bf16x3(torch.from_numpy(A))][:terms][::-1]
    Bd = B.astype(np.float64)
    acc = np.zeros((A.shape[1], B.shape[1]), np.float32)
    for q0 in range(0, A.shape[0], slab):
        for t in parts:
            acc = acc + (t[q0:q0 + slab].T @ Bd[q0:q0 + slab]).astype(np.float32)
    return acc


GEMM_CASES = [(128, 1.0), (128, 4.0), (64, 1.0), (100, 4.0)]


def _gemm_inputs(P: int, w_scale: float):
    rng = np.random.default_rng(P + int(w_scale))
    A = (w_scale * rng.normal(0.0, 1.0 / np.sqrt(P), (P, 128))).astype(np.float32)
    B = torch.from_numpy(rng.normal(0.0, 1.0, (P, 128)).astype(np.float32)) \
        .to(torch.bfloat16).float().numpy()
    exact = A.astype(np.float64).T @ B.astype(np.float64)
    absum = np.abs(A.astype(np.float64)).T @ np.abs(B.astype(np.float64))
    return A, B, exact, absum


@pytest.mark.parametrize("P,w_scale", GEMM_CASES)
def test_three_term_gemm_meets_the_f64_product_sum(P, w_scale):
    A, B, exact, absum = _gemm_inputs(P, w_scale)
    err = np.abs(emulated_gemm(A, B) - exact) / absum
    assert err.max() <= GEMM_ULPS * U, err.max() / U


@pytest.mark.parametrize("P,w_scale", [(128, 1.0), (100, 4.0)])
def test_three_term_gemm_meets_jax_bf16_times_f32_product(P, w_scale):
    A, B, _, absum = _gemm_inputs(P, w_scale)
    want = np.asarray(jnp.matmul(jnp.asarray(B.T, dtype=jnp.bfloat16), jnp.asarray(A)))
    assert want.dtype == np.float32
    err = np.abs(emulated_gemm(A, B).T - want) / absum.T
    assert err.max() <= 2 * GEMM_ULPS * U, err.max() / U


@pytest.mark.parametrize("terms", [2, 1])
@pytest.mark.parametrize("P,w_scale", [(128, 1.0), (64, 1.0)])
def test_fewer_terms_fail_the_bound(terms, P, w_scale):
    A, B, exact, absum = _gemm_inputs(P, w_scale)
    err = np.abs(emulated_gemm(A, B, terms) - exact) / absum
    assert err.max() > 4 * GEMM_ULPS * U, err.max() / U
