"""Port parity: bundles, parameter files and mid-sweep checkpoints
(`gpe_tpu_torch.io`) against the JAX package's format, `train_plpinn`'s
checkpoint resume, and the JAX-trained `gpe2d_ground_state` artifact
(runs/gpe2d_ground_state/bundle.pkl) rebuilt at full width on both sides.

Tolerances: the round trips are exact (the same numpy leaves); a resumed
sweep gives the uninterrupted sweep's μ table bit for bit; the artifact's
μ through the port's plain f32 path is held to the JAX package's f32 μ on
the same rebuilt bases within 1e-5 relative (f32 forward-Laplacian passes
of 50,176 points in another summation order).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.experiments.configs import EXPERIMENTS as JEXP  # noqa: E402
from gpe_tpu.io import checkpoint as jck  # noqa: E402
from gpe_tpu.train import plpinn as jpl  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.experiments.configs import EXPERIMENTS  # noqa: E402
from gpe_tpu_torch.io import checkpoint as tck  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import plpinn as tpl  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "runs" / "gpe2d_ground_state" / "bundle.pkl"


def _params(seed, layers=(1, 8, 8, 1)):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((i, o)).astype(np.float32),
                  rng.standard_normal(o).astype(np.float32))
                 for i, o in zip(layers[:-1], layers[1:]))


def _result(cls, to_leaf):
    by_gamma = {g: tuple((to_leaf(w), to_leaf(b)) for w, b in _params(int(g)))
                for g in (0.0, 5.0)}
    polished = {0: {"gamma": 5.0, "mu": 1.7, "steps": 3,
                    "params": by_gamma[5.0], "scale": 0.02,
                    "base_val": to_leaf(np.linspace(0, 1, 7, dtype=np.float32))}}
    hist = {0: {g: {"loss": np.arange(3.0), "mu": np.arange(3.0) + g} for g in by_gamma}}
    return cls({0: by_gamma}, {0: [(0.0, 1.0), (5.0, 1.7)]}, hist, {0: 0.5},
               {0: {0.0: 3, 5.0: 3}}, polished)


def _assert_bundle(b, spec_dtype_check):
    assert b["format_version"] == 1
    assert set(b) == {"params_by_mode", "mu_table", "training_history",
                      "constant_history", "epochs_history", "polished", "spec",
                      "extra", "format_version"}
    want = _result(tpl.PLPINNResult, lambda a: a)
    for g, ps in want.params_by_mode[0].items():
        for (w, bb), (gw, gb) in zip(ps, b["params_by_mode"][0][g]):
            assert isinstance(gw, np.ndarray)
            np.testing.assert_array_equal(gw, w)
            np.testing.assert_array_equal(gb, bb)
    np.testing.assert_array_equal(b["polished"][0]["base_val"],
                                  want.polished[0]["base_val"])
    assert b["mu_table"] == want.mu_table
    assert b["constant_history"] == {0: 0.5}
    assert b["epochs_history"] == {0: {0.0: 3, 5.0: 3}}
    assert b["spec"]["n_points"] == 64 and b["spec"]["layers"] == (1, 8, 8, 1)
    spec_dtype_check(b["spec"]["dtype"])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_bundle_round_trip_between_the_packages(tmp_path, direction):
    path = str(tmp_path / "sub" / "bundle.pkl")
    if direction == "port_to_jax":
        res = _result(tpl.PLPINNResult, torch.tensor)
        tck.save_bundle(path, res, tprob.GPESpec(n_points=64, layers=(1, 8, 8, 1)))
        _assert_bundle(jck.load_bundle(path), lambda d: d == "float32")
    else:
        res = _result(jpl.PLPINNResult, jnp.asarray)
        jck.save_bundle(path, res, jprob.GPESpec(n_points=64, layers=(1, 8, 8, 1)))
        _assert_bundle(tck.load_bundle(path),
                       lambda d: isinstance(d, tck.ForeignClass) and "jax" in d.name)


def test_params_files_between_the_packages(tmp_path):
    p = _params(3)
    tck.save_params(str(tmp_path / "t.pkl"), params_from_numpy(p, device="cpu"))
    jck.save_params(str(tmp_path / "j.pkl"), tuple((jnp.asarray(w), jnp.asarray(b))
                                                   for w, b in p))
    for got in (jck.load_params(str(tmp_path / "t.pkl")),
                tck.load_params(str(tmp_path / "j.pkl"))):
        for (w, b), (gw, gb) in zip(p, got):
            np.testing.assert_array_equal(np.asarray(gw), w)
            np.testing.assert_array_equal(np.asarray(gb), b)
    with pytest.raises(ValueError, match="orbax"):
        tck.save_params(str(tmp_path / "adir"), p)


def test_the_jax_artifact_loads_without_jax():
    """The port reads a JAX-written bundle on a machine without JAX: the
    spec's jax.numpy dtype becomes a ForeignClass."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "from gpe_tpu_torch.io import load_bundle\n"
            f"b = load_bundle({str(ARTIFACT)!r})\n"
            "print(sorted(b['params_by_mode'][0]), b['spec']['dtype'],"
            " b['polished'][0]['mu'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ForeignClass('jax.numpy.float32')" in out.stdout
    assert "5.759623050689697" in out.stdout


def test_sweep_checkpointer_and_train_or_load(tmp_path):
    path = str(tmp_path / "ck" / "sweep.pkl")
    ck = tck.SweepCheckpointer(path)
    ck.put("0:1.0", {"mu": 1.5, "params": params_from_numpy(_params(1), device="cpu")})
    ck.put("state:0", {"done_gammas": [1.0]})
    again = tck.SweepCheckpointer(path)
    assert again.keys() == ["0:1.0", "state:0"]
    np.testing.assert_array_equal(again.get("0:1.0")["params"][0][0], _params(1)[0][0])
    assert jck.SweepCheckpointer(path).get("state:0") == {"done_gammas": [1.0]}
    assert not os.path.exists(path + ".tmp")

    calls = []

    def train_fn():
        calls.append(1)
        return _result(tpl.PLPINNResult, torch.tensor)

    bpath = str(tmp_path / "b.pkl")
    b1 = tck.train_or_load(bpath, train_fn)
    b2 = tck.train_or_load(bpath, train_fn)            # loads, does not retrain
    assert len(calls) == 1 and b1["mu_table"] == b2["mu_table"]
    tck.train_or_load(bpath, train_fn, force_train=True)
    assert len(calls) == 2


def test_train_plpinn_resumes_from_its_checkpoint(tmp_path):
    """A sweep stopped after its first rung and resumed from checkpoint_path
    gives the uninterrupted sweep's μ table, epochs and histories."""
    spec = tprob.GPESpec(n_points=64, layers=(1, 16, 16, 1), lb=-8.0, ub=8.0,
                         nonlinearity="abs_power")
    run = dict(epochs=40, pretrain_epochs=60, check_every=20, rebase=True,
               device="cpu")
    gammas = (0.0, 1.0, 2.0)
    full = tpl.train_plpinn(spec, gammas, checkpoint_path=str(tmp_path / "a.pkl"), **run)
    first = tpl.train_plpinn(spec, gammas[:1], checkpoint_path=str(tmp_path / "b.pkl"),
                             **run)
    assert first.mu_table[0] == full.mu_table[0][:1]
    resumed = tpl.train_plpinn(spec, gammas, checkpoint_path=str(tmp_path / "b.pkl"),
                               pretrain_epochs=10 ** 6, **{k: v for k, v in run.items()
                                                          if k != "pretrain_epochs"})
    assert resumed.mu_table == full.mu_table
    assert resumed.epochs_history == full.epochs_history
    assert resumed.seconds["fit"][0].keys() == {1.0, 2.0}   # γ = 0 was not refit
    for g in gammas:
        np.testing.assert_array_equal(resumed.training_history[0][g]["loss"],
                                      full.training_history[0][g]["loss"])
        for (w, b), (fw, fb) in zip(resumed.params_by_mode[0][g],
                                    full.params_by_mode[0][g]):
            np.testing.assert_array_equal(w, fw)


def _jax_rebuild(bundle, rungs, scale):
    cfg = JEXP["gpe2d_ground_state"]
    loss_fn = jprob.make_loss_fn(cfg.spec)
    batch = jprob.make_batch(cfg.spec, 0)
    key = jax.random.PRNGKey(0)
    as_j = lambda p: tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in p)
    mus = {}
    with jax.default_matmul_precision("highest"):
        for g in rungs:
            if g == rungs[-1]:
                mus["rung"] = float(loss_fn(as_j(bundle["params_by_mode"][0][g]), batch,
                                            jnp.float32(g), jnp.float32(scale))[1]["mu"])
            batch, _ = jpl._rebase(cfg.spec, batch, as_j(bundle["params_by_mode"][0][g]),
                                   scale, key)
        mus["polished"] = float(loss_fn(as_j(bundle["polished"][0]["params"]), batch,
                                        jnp.float32(rungs[-1]), jnp.float32(scale))[1]["mu"])
    return mus


def _port_rebuild(bundle, rungs, scale):
    spec = EXPERIMENTS["gpe2d_ground_state"].spec
    loss_fn = tprob.make_loss_fn(spec)
    batch = tprob.make_batch(spec, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    as_t = lambda p: params_from_numpy(p, device="cpu")
    mus = {}
    with torch.no_grad():
        for g in rungs:
            if g == rungs[-1]:
                mus["rung"] = float(loss_fn(as_t(bundle["params_by_mode"][0][g]), batch,
                                            g, scale)[1]["mu"])
            batch, _ = tpl._rebase(spec, batch, as_t(bundle["params_by_mode"][0][g]),
                                   scale, gen)
        mus["polished"] = float(loss_fn(as_t(bundle["polished"][0]["params"]), batch,
                                        rungs[-1], scale)[1]["mu"])
    return mus


def test_jax_artifact_rebuilt_at_full_width_matches_jax():
    """The JAX-trained gpe2d_ground_state bundle at full width (50,176
    points, [2,128,128,128,1]): the base a rung trained against is the
    Hermite base plus scale·Σ N(params of the rungs before it), the polished
    params' base folds all 8 rungs (train_plpinn rebases after every rung).
    μ of the γ=100 rung and of the polished params, port vs JAX package."""
    with open(ARTIFACT, "rb") as f:
        bundle = pickle.load(f)
    rungs = sorted(bundle["params_by_mode"][0])
    assert len(rungs) == 8 and rungs[-1] == 100.0
    scale = EXPERIMENTS["gpe2d_ground_state"].perturb_const / bundle["constant_history"][0]
    want = _jax_rebuild(bundle, rungs, scale)
    got = _port_rebuild(bundle, rungs, scale)
    for k in ("rung", "polished"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)
    # the yardstick finding: on f32 CPU numerics the artifact's polished
    # params score ~2.4e-3 off the oracle's 5.7597536, not its recorded 1.3e-4
    assert abs(want["polished"] - 5.759753649270388) > 1e-3
