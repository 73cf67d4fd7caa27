"""The runner's `--plots` against the JAX runner's on copies of the
committed bundles, on the CPU: the same PNG file names in every directory,
and identical pixels for every figure drawn from bundle data alone
(`mu_vs_gamma`, `mu_vs_beta`, `loss_history`, both heatmaps,
`mode0_cross_potential`). `wavefunctions.png` draws the nets evaluated by
each library, which tests/test_torch_viz.py holds to 1e-5.

Each render starts from `matplotlib.rcdefaults()`; PNGs are compared as
`matplotlib.image.imread` arrays.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from gpe_tpu.experiments import run as jrun  # noqa: E402
from gpe_tpu_torch.experiments import run  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUNDLE_RUNS = ("gpe1d_tf", "gpe2d_ground_state", "gpe2d_lattice", "harmonic_quick",
               "linear_1d_sanity", "mode0_all_potentials", "plpinn_sharded_dp",
               "vary_beta_box_gaussian", "vary_beta_gravity_well", "vary_beta_harmonic")
FROM_NETS = {"wavefunctions.png"}


@pytest.mark.parametrize("name", BUNDLE_RUNS)
def test_plots_mode_draws_the_jax_runners_figures(name, tmp_path):
    mpl = pytest.importorskip("matplotlib")
    from matplotlib import image

    for side in ("jax", "port"):
        (tmp_path / side / name).mkdir(parents=True)
        for b in (ROOT / "runs" / name).glob("*bundle.pkl"):
            shutil.copy(b, tmp_path / side / name)
    mpl.rcdefaults()
    assert jrun.main([name, "--plots", "--cpu", "--out", str(tmp_path / "jax")]) == 0
    mpl.rcdefaults()
    assert run.main([name, "--plots", "--cpu", "--out", str(tmp_path / "port")]) == 0
    assert not torch.distributed.is_initialized()     # no process group for --plots
    pngs = {side: sorted(p.name for p in (tmp_path / side / name).glob("*.png"))
            for side in ("jax", "port")}
    assert pngs["jax"] and pngs["port"] == pngs["jax"]
    for png in set(pngs["jax"]) - FROM_NETS:
        a, b = (image.imread(str(tmp_path / side / name / png)) for side in ("jax", "port"))
        assert a.shape == b.shape and np.array_equal(a, b), png
