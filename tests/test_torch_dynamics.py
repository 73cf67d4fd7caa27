"""Port parity of the TDGPE propagators (gpe_tpu_torch/dynamics): the
split-step FFT engine and the GEMM engine against the JAX package's, on the
same inputs, at tests/test_gemm_step.py's shapes.

Tolerances. float64 (JAX under enable_x64, the port with float64 V): the
same operations in the same order on pocketfft (JAX) and torch's CPU FFT,
so ψ within atol 1e-12 and the observables within rtol 1e-10 after 120
steps (round-off of the two FFTs and exp, not bit-equality). float32: ψ
within atol 2e-5 (|ψ| ≤ 0.6, f32 round-off of ~2 transforms per step over
120 steps) and the observables within rtol 2e-5 (atol 2e-5 of the largest
value of each, since a centre of 0 is round-off).
"""
import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from gpe_tpu.dynamics import evolve as jevolve  # noqa: E402
from gpe_tpu.dynamics import ground_state as jground_state  # noqa: E402
from gpe_tpu.dynamics.gemm_step import evolve_gemm as jevolve_gemm  # noqa: E402
from gpe_tpu.dynamics.gemm_step import ground_state_gemm as jground_state_gemm  # noqa: E402
from gpe_tpu.dynamics.split_step import _dst1_ortho as j_dst1  # noqa: E402
from gpe_tpu_torch.dynamics import (evolve, evolve_gemm, ground_state,  # noqa: E402
                                    ground_state_gemm)
from gpe_tpu_torch.dynamics.gemm_step import matmul_precision  # noqa: E402
from gpe_tpu_torch.dynamics.split_step import _dst1_ortho  # noqa: E402

OBS = ("norm", "energy", "mu", "center", "width_sq")
TOL = {"f64": (1e-12, 1e-10), "f32": (2e-5, 2e-5)}


def _setup(n=48, half=7.0, d=0.4):
    x = np.linspace(-half, half, n, endpoint=False)
    dx = x[1] - x[0]
    X, Y = np.meshgrid(x, x, indexing="ij")
    V = 0.5 * (X ** 2 + Y ** 2)
    psi0 = np.exp(-0.5 * ((X - d) ** 2 + Y ** 2)) * np.exp(0.3j * X)
    psi0 = psi0 / np.sqrt(np.sum(np.abs(psi0) ** 2) * dx * dx)
    return x, dx, V, psi0


def _close(got, want, prec):
    atol, rtol = TOL[prec]
    (psi, obs), (jpsi, jobs) = got, want
    np.testing.assert_allclose(psi.numpy(), np.asarray(jpsi), rtol=0, atol=atol)
    for key in OBS:
        want = np.asarray(jobs[key])     # a centre of 0 is round-off: scale atol
        np.testing.assert_allclose(obs[key], want, rtol=rtol,
                                   atol=rtol * np.max(np.abs(want)), err_msg=key)
    np.testing.assert_allclose(obs["t"], np.asarray(jobs["t"]))


def _cast(prec, V, psi0):
    if prec == "f64":
        return V.astype(np.float64), psi0.astype(np.complex128)
    return V.astype(np.float32), psi0.astype(np.complex64)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("engine", ["fft", "gemm"])
@pytest.mark.parametrize("bc,imaginary", [("periodic", False), ("periodic", True),
                                          ("dirichlet", False)])
def test_evolve_matches_jax(prec, engine, bc, imaginary):
    x, dx, V, psi0 = _setup()
    V, psi0 = _cast(prec, V, psi0)
    kw = dict(dt=2e-3, steps=120, gamma=15.0, kinetic=0.5, bc=bc, lb=float(x[0]),
              imaginary=imaginary, record_every=40)
    port, ref = (evolve, jevolve) if engine == "fft" else (evolve_gemm, jevolve_gemm)
    got = port(psi0, V, dx, **kw, device="cpu")
    assert got[0].dtype == (torch.complex128 if prec == "f64" else torch.complex64)
    with jax.enable_x64(prec == "f64"):
        want = ref(psi0, V, dx, **kw)
        _close(got, want, prec)


@pytest.mark.parametrize("engine", ["fft", "gemm"])
def test_1d_3d_and_remainder_match_jax_f64(engine):
    port, ref = (evolve, jevolve) if engine == "fft" else (evolve_gemm, jevolve_gemm)
    n, half = 16, 6.0
    x = np.linspace(-half, half, n, endpoint=False)
    dx = x[1] - x[0]
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    V = 0.5 * (X ** 2 + Y ** 2 + Z ** 2)
    psi0 = np.exp(-0.5 * ((X - 0.4) ** 2 + Y ** 2 + Z ** 2)).astype(complex)
    psi0 /= np.sqrt(np.sum(np.abs(psi0) ** 2) * dx ** 3)
    kw = dict(dt=2e-3, steps=70, gamma=10.0, lb=float(x[0]), record_every=30)
    got = port(psi0, V, dx, **kw, device="cpu")
    assert len(got[1]["t"]) == 4 and abs(got[1]["t"][-1] - 0.140) < 1e-12
    V1 = 0.5 * x * x
    p1 = np.exp(-0.5 * (x - 0.3) ** 2).astype(complex)
    p1 /= np.sqrt(np.sum(np.abs(p1) ** 2) * dx)
    got1 = port(p1, V1, dx, 1e-3, 100, 5.0, lb=float(x[0]), record_every=50,
                device="cpu")
    with jax.enable_x64(True):
        _close(got, ref(psi0, V, dx, **kw), "f64")
        _close(got1, ref(p1, V1, dx, 1e-3, 100, 5.0, lb=float(x[0]),
                         record_every=50), "f64")


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("engine", ["fft", "gemm"])
@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
def test_ground_state_matches_jax(prec, engine, bc):
    """The imaginary-time ground state (the default start, chunked μ check)
    on both engines: μ and the state within 1e-10 in f64, 2e-5 in f32."""
    _, dx, V, _ = _setup(n=48)
    V = V.astype(np.float64 if prec == "f64" else np.float32)
    port, ref = ((ground_state, jground_state) if engine == "fft"
                 else (ground_state_gemm, jground_state_gemm))
    kw = dict(tau=2e-3, steps=1000, tol=0.0, bc=bc)
    got = port(V, dx, 30.0, **kw, device="cpu")
    with jax.enable_x64(prec == "f64"):
        want = ref(V, dx, 30.0, **kw)
    tol = 1e-10 if prec == "f64" else 2e-5
    assert abs(got[0] - want[0]) < tol * abs(want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=tol)


def test_ground_state_stops_on_tolerance_like_jax():
    """A loose tolerance stops both at the same chunk: the same μ."""
    _, dx, V, _ = _setup(n=32)
    got = ground_state(V, dx, 10.0, tau=2e-3, steps=20000, tol=1e-4, device="cpu")
    with jax.enable_x64(True):
        want = jground_state(V, dx, 10.0, tau=2e-3, steps=20000, tol=1e-4)
    assert abs(got[0] - want[0]) < 1e-10


def test_dst1_is_an_involution_and_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(12, 9)) + 1j * rng.normal(size=(12, 9))
    t = torch.as_tensor(a)
    for axis in (0, 1):
        b = _dst1_ortho(t, axis)
        np.testing.assert_allclose(_dst1_ortho(b, axis).numpy(), a, atol=1e-13)
        with jax.enable_x64(True):
            np.testing.assert_allclose(b.numpy(), np.asarray(j_dst1(a, axis)),
                                       atol=1e-13)
    real = _dst1_ortho(torch.as_tensor(a.real), 0)
    assert real.dtype == torch.complex128
    np.testing.assert_allclose(real.imag.numpy(), 0.0, atol=1e-14)


def test_gemm_precision_is_scoped():
    """precision='default' allows TF32 inside the call only; the global
    setting is restored, whatever it was, and an unknown name is refused."""
    x, dx, V, psi0 = _setup(n=16)
    before = torch.get_float32_matmul_precision()
    with matmul_precision("default"):
        assert torch.get_float32_matmul_precision() == "high"
    assert torch.get_float32_matmul_precision() == before
    evolve_gemm(psi0.astype(np.complex64), V.astype(np.float32), dx, 1e-3, 3, 1.0,
                precision="default", device="cpu")
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(ValueError, match="precision"):
        evolve_gemm(psi0, V, dx, 1e-3, 3, 1.0, precision="high", device="cpu")
