"""The port's benchmark (gpe_tpu_torch/bench.py) on the CPU at a tiny size:
the record's keys, parity failures and unresolved times raise (nothing is
skipped or clamped), and the bf16 plain loss it times against the JAX
package's make_loss_fn with bf16 on the same inputs."""
import json
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch import bench  # noqa: E402
from gpe_tpu_torch.models import mlp as tmlp  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

TINY = dict(device="cpu", n_side=16, layers=(2, 24, 24, 24, 1), iters=1, dyn_n=16,
            dyn_steps=40)
KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_pts_per_sec", "device",
        "power_limit", "n_pts", "total_loss", "best_eval_pts_per_sec",
        "xla_eval_pts_per_sec", "train_step_pts_per_sec",
        "fused_train_step_pts_per_sec", "fused_train_step_relaxed_pts_per_sec",
        "bf16_eval_pts_per_sec", "pallas_eval_pts_per_sec",
        "pallas_bf16_eval_pts_per_sec", "rowcat_eval_pts_per_sec",
        "rowcat_bf16_eval_pts_per_sec", "dynamics_grid_pt_steps_per_sec",
        "eval_tflops", "eval_mfu_vs_f32_peak", "bf16_eval_mfu_vs_bf16_peak",
        "pallas_vs_xla_rel_err",
        "pallas_bf16_vs_xla_rel_err", "rowcat_vs_xla_rel_err",
        "rowcat_bf16_vs_xla_rel_err"}


def test_measure_gives_every_key_with_finite_rates():
    rec = bench.measure(**TINY)
    assert KEYS <= set(rec)
    assert rec["device"] == "cpu" and rec["n_pts"] == 256
    json.loads(json.dumps(rec))
    for k, v in rec.items():
        if k.endswith("_per_sec") or k.endswith("_rel_err"):
            assert math.isfinite(v) and v >= 0.0, k
    assert rec["value"] == rec["best_eval_pts_per_sec"]
    assert rec["pallas_vs_xla_rel_err"] < bench.LOSS_TOL_F32
    assert rec["rowcat_bf16_vs_xla_rel_err"] < bench.LOSS_TOL_BF16
    flops = bench.matmul_flops((2, 24, 24, 24, 1), 256, grad=False)
    assert rec["eval_tflops"] == pytest.approx(flops * rec["value"] / 256 / 1e12)
    best_bf16 = max(rec["pallas_bf16_eval_pts_per_sec"],
                    rec["rowcat_bf16_eval_pts_per_sec"])
    assert rec["bf16_eval_mfu_vs_bf16_peak"] == pytest.approx(
        flops * best_bf16 / 256 / bench.PEAK_FLOPS["bf16"])


def test_a_parity_failure_fails_the_run(monkeypatch):
    from gpe_tpu_torch.kernels import rowcat_eval as k4

    real = k4.collocation_sums
    monkeypatch.setattr(k4, "collocation_sums",
                        lambda *a, **kw: real(*a, **kw) * 1.5)
    with pytest.raises(bench.ParityError, match="rowcat"):
        bench.measure(**TINY)


def test_no_time_is_clamped(monkeypatch):
    for ms in (0.0, -1e-3, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="does not resolve"):
            bench.per_sec(1.0, ms, "x")
    monkeypatch.setattr(bench, "time_ms", lambda fn, iters, device, warmup=2: 0.0)
    with pytest.raises(ValueError, match="does not resolve"):
        bench.measure(**TINY)


def test_the_device_is_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.measure(n_side=8, layers=(2, 8, 8, 1), iters=1)


def test_bf16_plain_loss_matches_jax_make_loss_fn_bf16():
    """spec.dtype = bfloat16 on the same bf16 inputs: the port keeps bf16
    elements and f32 sums as JAX does, but the two frameworks round at other
    places in the loss (JAX promotes with the f32 γ where torch keeps bf16),
    so total and μ agree to bf16 round-off, rtol 2e-2. The bf16 network
    they share — value and Laplacian per point — agrees to a tenth of a bf16
    ulp at its largest value (bit for bit on the CPU); the f32 network
    misses that by a bf16 ulp or more."""
    kw = dict(dim=2, n_points=16, layers=(2, 24, 24, 24, 1), potential="harmonic",
              potential_kwargs=(("a", 0.5),), kinetic=0.5, basis="hermite",
              lb=-6.0, ub=6.0, nonlinearity="abs_power", use_perturbation=False)
    jspec = jprob.GPESpec(**kw, dtype=jnp.bfloat16)
    tspec = tprob.GPESpec(**kw, dtype=torch.bfloat16)
    jparams = jmlp.init_mlp(jax.random.PRNGKey(0), jspec.layers, dtype=jnp.bfloat16)
    jbatch = jprob.make_batch(jspec, 0)
    to_t = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    tparams = tuple((to_t(w), to_t(b)) for w, b in jparams)
    tbatch = {k: to_t(v) for k, v in jbatch.items()}
    jtot, jaux = jprob.make_loss_fn(jspec)(jparams, jbatch, jnp.float32(100.0),
                                          jnp.float32(0.01))
    ttot, taux = tprob.make_loss_fn(tspec)(tparams, tbatch, 100.0, 0.01)
    assert ttot.dtype == torch.float32
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=2e-2)
    np.testing.assert_allclose(float(taux["mu"]), float(jaux["mu"]), rtol=2e-2)
    jnet = jmlp.mlp_vgl(jparams, jbatch["x"], jspec.activation)
    tnet = tmlp.mlp_vgl(tparams, tbatch["x"], tspec.activation)
    fnet = tmlp.mlp_vgl(tuple((w.float(), b.float()) for w, b in tparams),
                        tbatch["x"].float(), tspec.activation)
    for field in ("value", "lap"):
        want = np.asarray(getattr(jnet, field), np.float32)
        atol = 0.1 * 2.0 ** -8 * np.abs(want).max()
        np.testing.assert_allclose(getattr(tnet, field).float().numpy(), want,
                                   rtol=0, atol=atol, err_msg=field)
        assert np.abs(getattr(fnet, field).numpy() - want).max() > atol, field


def _scripted_propagator(monkeypatch, times):
    """An engine that records its step count and a host timer that runs the
    call and answers times(step count): the timings propagator_ms reads."""
    seen = []

    def engine(psi, V, dx, dt, k, gamma, **kw):
        seen.append(k)
        return psi, {"norm": np.ones(1)}

    def fake_time_ms(fn, iters, device, warmup=2):
        fn()
        return times(seen[-1])

    monkeypatch.setattr(bench, "time_ms", fake_time_ms)
    return engine


def test_propagator_ms_doubles_the_steps_until_the_difference_resolves(monkeypatch):
    # at 40 and 80 steps the 2·S call reads faster than the S call (a loaded
    # host): the best-of-three difference is negative there; from 160 steps on
    # the time grows by 0.01 ms a step
    times = lambda k: {40: 10.0, 80: 9.9}.get(k, 9.0 + 0.01 * k)
    engine = _scripted_propagator(monkeypatch, times)
    ms = bench.propagator_ms(engine, torch.device("cpu"), n=8, steps=40)
    assert ms > 0.0
    assert ms == pytest.approx((times(160) - times(80)) / 80)


def test_propagator_ms_raises_where_the_difference_never_resolves(monkeypatch):
    engine = _scripted_propagator(monkeypatch, lambda k: 10.0 - 1e-3 * k)
    with pytest.raises(ValueError, match="does not resolve"):
        bench.propagator_ms(engine, torch.device("cpu"), n=8, steps=40)
