"""The benchmark's plain reference against the port's plain CPU path at a
small size: the arrays, the sums, the LM residual in float64, and the
followed steps of both drivers in float32."""
import numpy as np
import pytest
import torch

from port_bench import harness, reference
from port_bench.run import ROOT
from port_bench.tests._tiny import tiny

F64 = torch.float64
CPU = torch.device("cpu")


def _cell(name, seed=7):
    cell = harness.find_cell(ROOT, name, seed, CPU)
    tiny(cell)
    return cell


def _program_f64(cell):
    from gpe_tpu_torch.train.problem import make_batch

    spec, _ = harness.program_problem(cell, cell.config["spec"]["n_points"])
    spec = spec.__class__(**{**spec.__dict__, "dtype": F64})
    return spec, make_batch(spec, 0, device=CPU)


@pytest.mark.parametrize("name", ["gs2d.polish", "lattice.polish"])
def test_arrays_and_sums_match_the_port(name):
    from gpe_tpu_torch.kernels.fused_residual import collocation_sums_plain

    cell = _cell(name)
    spec, batch = _program_f64(cell)
    prob = harness.reference_problem(cell, spec.n_points)
    for ours, theirs in (("x", "x"), ("V", "V"), ("bx", "bx"), ("base_val", "base_val"),
                         ("base_lap", "base_lap"), ("base_bval", "base_bval")):
        np.testing.assert_allclose(getattr(prob, ours).numpy(), batch[theirs].numpy(),
                                   rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(batch["w"].numpy(), prob.w, rtol=1e-14)
    p = tuple((W.double(), b.double()) for W, b in
              harness.seeded_params(spec.layers, 3, CPU))
    got = collocation_sums_plain(p, batch["x"], batch["V"], batch["w"], 20.0, 0.3,
                                 batch["base_val"], batch["base_lap"], spec.activation,
                                 spec.p, spec.kinetic, spec.nonlinearity)
    np.testing.assert_allclose(reference.sums(p, prob, 20.0, 0.3).numpy(), got.numpy(),
                               rtol=1e-12)


def test_residual_matches_the_port():
    from gpe_tpu_torch.train.gauss_newton import make_gpe_residual_fn

    cell = _cell("gs2d.polish")
    spec, batch = _program_f64(cell)
    prob = harness.reference_problem(cell, spec.n_points)
    p = tuple((W.double(), b.double()) for W, b in
              harness.seeded_params(spec.layers, 4, CPU))
    got = make_gpe_residual_fn(spec)(p, batch, 100.0, 0.05)
    np.testing.assert_allclose(reference.residuals(p, prob, 100.0, 0.05).numpy(),
                               got.numpy(), rtol=1e-10, atol=1e-13)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, 3.0], dtype=torch.float32)
    # ties to even at the 10th mantissa bit
    assert reference.tf32_round(x).tolist() == [1.0, 1.0 + 2 ** -9, 3.0]


@pytest.mark.parametrize("name", ["gs2d.ramp"])
def test_fit_steps_follow_the_port(name):
    from port_bench.drivers import fit

    cell = _cell(name)
    st = fit.setup(cell)
    r = fit.step_readings(st, fit.program_steps(st), fit.followed(cell, st))
    rec = fit.window(cell, st, 0.0, False)
    rung = rec["rungs"][-1]
    r.update(fit.rung_readings(rung, fit._followed_rung(cell, st, rung)))
    assert max(r.values()) < 1e-4, r


@pytest.mark.parametrize("name", ["gs2d.polish", "lattice.polish"])
def test_lm_steps_follow_the_port(name):
    from port_bench.drivers import lm

    cell = _cell(name)
    st = lm.setup(cell)
    rec = lm.window(cell, st, 0.0, False)
    assert sorted(c["start"] for c in rec["calls"]) == list(range(len(st["starts"])))
    r = lm.check(cell, st, rec)
    assert r["step_loss"] < cell.limits["step_loss"], r
