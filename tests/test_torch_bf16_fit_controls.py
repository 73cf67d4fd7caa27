"""The controls of chip_smoke.py phase 11a's bf16 fit bound
(`experiments/bf16_fit_controls.py`) on the CPU, where K2's bf16 vag runs
its plain versions: the problems are the phase's shapes, each route's vag
(and its run-mode twin) is what it names, a planted fault changes the fit
and the sound route run again does not."""
from dataclasses import replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from gpe_tpu_torch.experiments import bf16_fit_controls as bc  # noqa: E402
from gpe_tpu_torch.experiments.configs import EXPERIMENTS  # noqa: E402
from gpe_tpu_torch.models.mlp import init_mlp, stack_runs  # noqa: E402
from gpe_tpu_torch.train.problem import make_batch  # noqa: E402

MSPEC = replace(EXPERIMENTS[bc.SINGLE].spec, n_points=64, layers=(2, 8, 8, 1))
ESPEC = replace(EXPERIMENTS[bc.ENSEMBLE].spec, n_points=48, layers=(1, 8, 8, 1))


def _probs():
    init = lambda spec, seed: init_mlp(spec.layers, "xavier_uniform",
                                       generator=torch.Generator().manual_seed(seed),
                                       device="cpu")
    return {"single": (MSPEC, make_batch(MSPEC, 0, device="cpu"), init(MSPEC, 0)),
            "ensemble": (ESPEC, make_batch(ESPEC, 0, device="cpu"),
                         stack_runs([init(ESPEC, 42 + r) for r in range(3)]),
                         [0.0, 20.0, 40.0], [0.01, 0.02, 0.03], 1e-3)}


def test_problems_are_the_phase_shapes():
    probs = bc.problems("cpu")
    mspec, mbatch, mparams = probs["single"]
    assert mspec.layers == (2, 128, 128, 128, 1) and mbatch["x"].shape == (50176, 2)
    assert [tuple(w.shape) for w, _ in mparams] == [(2, 128), (128, 128), (128, 128),
                                                     (128, 1)]
    espec, ebatch, eparams, gammas, scales, lr = probs["ensemble"]
    assert espec == EXPERIMENTS[bc.ENSEMBLE].spec and eparams[0][0].shape[0] == 6
    assert len(gammas) == len(scales) == 6 and lr == EXPERIMENTS[bc.ENSEMBLE].lr


@pytest.mark.parametrize("route", ["relaxed", "exact", "stale", "no_bias_grad"])
def test_make_vag_routes(route):
    """Every route is a bf16 vag with a run-mode twin; the relaxed ones are
    stateful, and a fault is planted in the twin too."""
    vag = bc.make_vag(ESPEC, route)
    assert getattr(vag, "stateful", False) == (route != "exact")
    assert vag.run_axis is not None
    if route in ("stale", "no_bias_grad"):
        assert vag.run_axis.__name__ == vag.__name__ != "vag_relaxed"


def test_sound_route_repeats_and_faults_part():
    """On the CPU the relaxed route run again is bit-equal; its reordered
    points stay within f32 summation order of it; each planted fault parts
    from it by more, in both fits, and no_bias_grad leaves the output bias
    where it started."""
    probs = _probs()
    ref = bc.fits(probs, "cpu")
    assert all(r.loss_history.shape[-1] == bc.STEPS for r in ref)
    assert bc.gaps(bc.fits(probs, "cpu"), ref) == {"fit": 0.0, "fit_ensemble": 0.0}
    sound = bc.gaps(bc.fits(probs, "cpu", reorder=True), ref)
    for fault in ("stale", "no_bias_grad"):
        got = bc.fits(probs, "cpu", fault)
        far = bc.gaps(got, ref)
        assert all(far[k] > sound[k] for k in far), (fault, far, sound)
        if fault == "no_bias_grad":
            for r, (_, _, params, *_) in zip(got, (probs["single"], probs["ensemble"])):
                assert torch.equal(r.final_params[-1][1], params[-1][1])


def test_hist_rel_is_the_worst_relative_gap():
    assert bc.hist_rel([1.0, 2.0, 4.0], [1.0, 2.5, 4.0]) == pytest.approx(0.2)
    assert np.isnan(bc.hist_rel([1.0], [1.0])) is np.False_
