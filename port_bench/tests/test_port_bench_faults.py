"""`correct` at a small size on the CPU: a sound run of each cell passes
its limits; with each fault a cell can have planted underneath the timed
path, the rest of the run goes on and `correct` comes out false; and the
control (the reference in TF32 in the program's place) fails a limit."""
import pytest
import torch

from port_bench import faults, harness
from port_bench.controls import readings
from port_bench.run import run_cell
from port_bench.tests._tiny import tiny

CELLS = ["gs2d.ramp", "gs2d.polish", "lattice.polish"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = run_cell(name, 11, 0.0, False, device="cpu", overrides=tiny)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    with faults.planted(fault):
        out = run_cell(name, 11, 0.0, False, device="cpu", overrides=tiny)
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("name", ["gs2d.polish", "lattice.polish"])
def test_a_solver_kept_across_calls_is_not_correct(name):
    with faults.planted("stale"):
        out = run_cell(name, 11, 0.0, False, device="cpu", overrides=tiny)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["step_loss"]["value"] > out["checks"]["step_loss"]["limit"]


def test_faults_are_removed_after():
    from gpe_tpu_torch.train import gauss_newton, optimizers

    before = (gauss_newton.make_lm_solver, optimizers.ClipAdam.update)
    with faults.planted("unchanged"):
        assert gauss_newton.make_lm_solver is not before[0]
    assert (gauss_newton.make_lm_solver, optimizers.ClipAdam.update) == before


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(name):
    cell = harness.find_cell(harness.HERE.parent, name, 11, torch.device("cpu"))
    r = readings(name, 11, "control", device="cpu", overrides=tiny)["readings"]
    ok, _ = harness.judge(r, cell.limits)
    assert not ok, r
