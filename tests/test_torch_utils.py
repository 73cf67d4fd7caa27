"""Port parity of the small modules: `ops/laplacian.py`'s generic (f, ∇f, Δf)
by torch.func, `train/schedules.py:cosine_annealing`, `utils/profiling.py`
and `utils/debug.py`, against the JAX package where it has a number.

Tolerances. The generic triple in float64 within 1e-12 of JAX's (x64) and
of the analytic derivatives; the forward-Laplacian MLP against it at 1e-10
(float64). cosine_annealing against optax's cosine_decay_schedule in
float32 at rtol 1e-6 over steps 0…T_max + 10 (both evaluate cos in f32).
"""
import math
import random
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from gpe_tpu.ops.laplacian import value_grad_lap_generic as j_vgl  # noqa: E402
from gpe_tpu.utils.profiling import throughput_meter as j_meter  # noqa: E402
from gpe_tpu_torch.models import mlp  # noqa: E402
from gpe_tpu_torch.ops.laplacian import (fwdlap_mlp, laplacian_generic,  # noqa: E402
                                         value_grad_lap_generic)
from gpe_tpu_torch.train.schedules import cosine_annealing  # noqa: E402
from gpe_tpu_torch.utils import (Timer, nan_guard, seed_everything,  # noqa: E402
                                 throughput_meter, trace)


def _f_torch(p):
    return torch.exp(-0.5 * torch.sum(p * p)) * torch.sin(p[0]) + p[-1] ** 3


def _f_jax(p):
    return jnp.exp(-0.5 * jnp.sum(p * p)) * jnp.sin(p[0]) + p[-1] ** 3


def _analytic(x):
    """(f, ∇f, Δf) of _f for points x (N, d)."""
    g = np.exp(-0.5 * np.sum(x * x, axis=1))
    s, c = np.sin(x[:, 0]), np.cos(x[:, 0])
    d = x.shape[1]
    val = g * s + x[:, -1] ** 3
    grad = -x * (g * s)[:, None]
    grad[:, 0] += g * c
    grad[:, -1] += 3 * x[:, -1] ** 2
    # Δ(g·s) = s·Δg + 2 ∂₀g ∂₀s + g Δs, Δg = (|x|² − d) g
    lap = s * (np.sum(x * x, axis=1) - d) * g - 2 * x[:, 0] * g * c - g * s + 6 * x[:, -1]
    return val, grad, lap


@pytest.mark.parametrize("d", [1, 2, 3])
def test_value_grad_lap_generic_matches_jax_and_analytic(d):
    x = np.random.default_rng(d).uniform(-2.0, 2.0, (37, d))
    got = value_grad_lap_generic(_f_torch, torch.as_tensor(x))
    with jax.enable_x64(True):
        want = j_vgl(_f_jax, jnp.asarray(x))
        want = [np.asarray(a, np.float64) for a in want]
    exact = _analytic(x)
    for a, b, c in zip(got, want, exact):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-12)
        np.testing.assert_allclose(a.numpy(), c, rtol=0, atol=1e-12)
    np.testing.assert_allclose(laplacian_generic(_f_torch, torch.as_tensor(x)).numpy(),
                               exact[2], rtol=0, atol=1e-12)


def test_value_grad_lap_generic_takes_1d_points_and_checks_fwdlap():
    """A (N,) input is read as N points in 1D, as in JAX; and the generic
    triple is an independent check of the forward-Laplacian MLP (f64)."""
    x = torch.linspace(-1.0, 1.0, 11, dtype=torch.float64)
    t = value_grad_lap_generic(lambda p: torch.sin(p[0]), x)
    np.testing.assert_allclose(t.lap.numpy(), -np.sin(x.numpy()), atol=1e-14)
    params = mlp.init_mlp((2, 8, 8, 1), generator=torch.Generator().manual_seed(0),
                          dtype=torch.float64, device="cpu")
    pts = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (20, 2)))
    ref = value_grad_lap_generic(
        lambda p: mlp.mlp_apply(params, p[None, :], "shifted_tanh")[0], pts)
    got = fwdlap_mlp(params, pts, "shifted_tanh")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.reshape(b.shape).numpy(), b.numpy(), atol=1e-10)


@pytest.mark.parametrize("base_lr,T_max,eta_min", [(1e-3, 100, 1e-5), (0.1, 37, 0.0),
                                                   (2e-2, 1, 1e-4)])
def test_cosine_annealing_matches_optax(base_lr, T_max, eta_min):
    sched = cosine_annealing(base_lr, T_max, eta_min)
    want = optax.cosine_decay_schedule(base_lr, T_max, alpha=eta_min / base_lr)
    steps = range(T_max + 11)
    got = np.array([float(sched(s)) for s in steps])
    ref = np.array([float(want(s)) for s in steps])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)
    assert got[0] == pytest.approx(base_lr, rel=1e-6)
    assert got[-1] == pytest.approx(eta_min, rel=1e-6, abs=1e-12)
    # a tensor step (the optimizer's count) gives the same value
    assert float(sched(torch.tensor(T_max // 2))) == pytest.approx(got[T_max // 2])
    with pytest.raises(ValueError):
        cosine_annealing(base_lr, 0)


def test_timer_and_throughput_meter():
    with Timer() as t:
        time.sleep(0.01)
    assert t.elapsed >= 0.01
    a = torch.ones(64, 64)
    got = throughput_meter(lambda m: m @ m, (a,), n_points=64, warmup=1, iters=3)
    want = j_meter(lambda m: m @ m, (jnp.ones((64, 64)),), n_points=64, warmup=1, iters=3)
    assert set(got) == set(want) == {"pts_per_sec", "pts_per_sec_per_chip", "sec_per_iter"}
    assert got["sec_per_iter"] > 0
    assert got["pts_per_sec"] == pytest.approx(64 / got["sec_per_iter"])
    # no CUDA device here: one "chip"
    assert got["pts_per_sec_per_chip"] == got["pts_per_sec"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as d:
        torch.ones(8) + 1
    assert d == str(tmp_path / "t") and (tmp_path / "t" / "trace.json").stat().st_size > 0


def test_seed_everything_is_reproducible():
    draws = []
    for _ in range(2):
        g = seed_everything(7)
        draws.append((random.random(), np.random.rand(), float(torch.rand(())),
                      float(torch.rand((), generator=g))))
    assert draws[0] == draws[1]
    g = seed_everything(8)
    assert (random.random(), float(torch.rand((), generator=g))) != draws[0][::3]
    assert isinstance(g, torch.Generator) and g.initial_seed() == 8


def test_nan_guard_raises_inside_its_scope_only():
    x = torch.tensor([1.0, -1.0])
    with nan_guard():
        torch.sqrt(torch.abs(x))                        # no NaN: no raise
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(x)
    assert math.isnan(float(torch.sqrt(x)[1]))          # outside: no raise
    a = torch.zeros(1, requires_grad=True)
    with nan_guard(), pytest.raises(FloatingPointError, match="NaN produced by"):
        torch.sum(a * torch.sqrt(a)).backward()         # 0·∞ in the backward
