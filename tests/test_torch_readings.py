"""Two readings of the port on the card that had no cause, held on the CPU:

- `experiments/numeric_probe.py`, which repeats chip_smoke.py 12b (the
  numeric sine-series base in float64, card against CPU) call after call
  in fresh processes: its readings and its verdicts;
- the lattice LM polish (`train/gauss_newton.make_lm_solver`) against the
  JAX package's from the same start: the params, batch, γ and scale that
  JAX's checkpoint LM was given at γ 5 of the lattice cut
  (tests/lattice_cut.py: 24², [2,32,32,1], 1,500 epochs a rung), seeds 0,
  3 and 5, saved by `tests/lattice_cut.py --lm-steps 300 --seeds 0 3 5
  --save-lm-start tests/lattice_lm_start.npz`.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gpe_tpu_torch.experiments import numeric_probe  # noqa: E402

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("order", ["cold", "batch"])
def test_numeric_probe_on_the_cpu(order):
    """Both sides on the CPU: every call equals the first bit for bit and
    the CPU reference, so every reading is 0 and neither verdict fires."""
    r = numeric_probe.probe(3, order, torch.device("cpu"))
    assert r["order"] == order and r["calls"] == 3 and len(r["err"]) == 3
    assert all(e == [0.0, 0.0, 0.0] for e in r["err"])
    assert r["equal_first"] == [True] * 3 and r["equal_second"] == [True] * 2
    v = numeric_probe.summarize([r, dict(r)])
    assert v["first_err"] == [0.0, 0.0] and v["later_max_err"] == 0.0
    assert not v["later_calls_vary"] and not v["first_call_differs"]
    assert v["digests"] == [r["digest_first"]] and v["procs"] == 2


@pytest.mark.parametrize("case", ["first_differs", "later_vary"])
def test_numeric_probe_verdicts_see_a_planted_difference(case):
    """summarize tells a first call that differs from a later call that
    varies: readings of a process whose first call (or whose third call)
    is not the second's bits."""
    ok = {"calls": 3, "err": [[1e-16] * 3] * 3, "equal_first": [True] * 3,
          "equal_second": [True, True], "digest_first": "a", "first_ms": 1.0,
          "later_ms": 0.5}
    if case == "first_differs":
        bad = dict(ok, err=[[2.7e-9] * 3, [1e-16] * 3, [1e-16] * 3],
                   equal_first=[True, False, False], digest_first="b")
    else:
        bad = dict(ok, err=[[1e-16] * 3, [1e-16] * 3, [3e-12] * 3],
                   equal_first=[True, True, False], equal_second=[True, False])
    v = numeric_probe.summarize([ok, bad])
    assert v["first_call_differs"] == (case == "first_differs")
    assert v["later_calls_vary"] == (case == "later_vary")
    assert v["digests"] == (["a", "b"] if case == "first_differs" else ["a"])
    assert v["later_max_err"] == (1e-16 if case == "first_differs" else 3e-12)


LM_START = os.path.join(HERE, "lattice_lm_start.npz")
LM_STEPS = 6            # the packages' λ histories agree this far at every seed
LM_MU_ATOL = 3e-3       # μ after LM_STEPS; each package on reordered points
#                         (lattice_cut.py --lm-from) moves it up to 1.37e-3
LM_LOSS_RTOL = 5e-2     # per step; reordered points move the port's by 2.26e-2


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_lattice_lm_follows_jax_from_jax_start(seed):
    """From what JAX's checkpoint LM was given at γ 5 of the lattice cut:
    JAX's solver, run again, is that LM's run bit for bit; the port's
    solver accepts and rejects the same steps (the same λ at every step),
    its losses and μ within the spread that a reordering of the points
    gives either package (LM_MU_ATOL, LM_LOSS_RTOL). Over 300 steps both
    accept most steps (PERF.md §6)."""
    from lattice_cut import load_lm_start, lm_both

    st = load_lm_start(LM_START, seed)
    both = lm_both(st, lm_steps=LM_STEPS)
    j, t = both["jax"], both["torch"]
    np.testing.assert_array_equal(j["losses"], st["losses"][:LM_STEPS])
    np.testing.assert_array_equal(j["lams"], st["lams"][:LM_STEPS])
    np.testing.assert_allclose(t["lams"], j["lams"], rtol=1e-6)
    assert t["accepted"] == j["accepted"] >= LM_STEPS - 1
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=LM_LOSS_RTOL)
    assert abs(t["mu"] - j["mu"]) <= LM_MU_ATOL, (t["mu"], j["mu"])


def test_lattice_lm_bounds_see_a_planted_fault():
    """The same check from a start whose base Laplacian is zeroed on the
    port's side only: μ leaves JAX's by far more than LM_MU_ATOL."""
    from lattice_cut import load_lm_start, lm_both

    st = load_lm_start(LM_START, 5)
    fault = dict(st, batch=dict(st["batch"], base_lap=np.zeros_like(st["batch"]["base_lap"])))
    t = lm_both(fault, lm_steps=1)["torch"]
    j = lm_both(st, lm_steps=1)["jax"]
    assert abs(t["mu"] - j["mu"]) > 10 * LM_MU_ATOL, (t["mu"], j["mu"])
