"""The controls of chip_smoke.py phase 7a (`experiments/sweep_controls.py`)
on the CPU, where the relaxed step runs the kernels' plain versions: each
planted fault changes what it plants and nothing else, a reordered batch
holds the same points, and a sweep on a route goes through that route's
step."""
from dataclasses import replace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from gpe_tpu_torch.experiments import sweep_controls as sc  # noqa: E402
from gpe_tpu_torch.experiments.configs import EXPERIMENTS  # noqa: E402
from gpe_tpu_torch.models.mlp import init_mlp  # noqa: E402
from gpe_tpu_torch.train import beta_sweep  # noqa: E402
from gpe_tpu_torch.train.loop import fit  # noqa: E402
from gpe_tpu_torch.train.optimizers import make_optimizer  # noqa: E402
from gpe_tpu_torch.train.problem import make_batch, make_loss_fn  # noqa: E402

SPEC = replace(EXPERIMENTS[sc.CONFIG].spec, n_points=64, layers=(1, 8, 8, 1))


def _case():
    batch = make_batch(SPEC, 0, device="cpu")
    params = init_mlp(SPEC.layers, "xavier_uniform",
                      generator=torch.Generator().manual_seed(0), device="cpu")
    return params, batch


def _leaves(grads):
    return [t for pair in grads for t in pair]


def test_stale_cotangents_keep_the_first_sums():
    """The first step of the stale fault is the relaxed step's, bit for
    bit; its state keeps the sums it was given, so that from the third
    step on (the first whose cotangents come from moved params) its fit
    parts from the relaxed step's."""
    params, batch = _case()
    relaxed, stale = sc.make_vag(SPEC, "relaxed"), sc.make_vag(SPEC, "stale")
    state = relaxed.init_state(params, batch, 0.0, 0.01)
    (v1, _), g1, _ = relaxed(params, batch, 0.0, 0.01, state)
    (v2, _), g2, s2 = stale(params, batch, 0.0, 0.01, state)
    assert torch.equal(v1, v2) and all(map(torch.equal, _leaves(g1), _leaves(g2)))
    assert s2[0] is state[0] and s2[1] is state[1] and s2[2] == 1
    opt = make_optimizer("adam", 1e-2)
    hists = [fit(make_loss_fn(SPEC), opt, params, batch, 0.0, 0.01, epochs=8, tol=-1.0,
                 patience=10**9, check_every=8, value_and_grad_fn=vag).loss_history
             for vag in (relaxed, stale)]
    np.testing.assert_array_equal(hists[0][:3], hists[1][:3])
    assert not np.array_equal(hists[0][3:], hists[1][3:])


def test_no_bias_grad_zeroes_the_output_bias_gradient_alone():
    params, batch = _case()
    relaxed, dropped = sc.make_vag(SPEC, "relaxed"), sc.make_vag(SPEC, "no_bias_grad")
    state = relaxed.init_state(params, batch, 0.0, 0.01)
    _, g1, s1 = relaxed(params, batch, 0.0, 0.01, state)
    _, g2, s2 = dropped(params, batch, 0.0, 0.01, state)
    want = _leaves(g1)
    got = _leaves(g2)
    assert torch.count_nonzero(want[-1]) > 0 and torch.count_nonzero(got[-1]) == 0
    assert all(map(torch.equal, want[:-1], got[:-1]))
    assert all(map(torch.equal, s1[:2], s2[:2]))


def test_reordered_batch_holds_the_same_points():
    _, batch = _case()
    again = sc.reordered(batch)
    perm = np.random.default_rng(1).permutation(batch["x"].shape[0])
    assert not np.array_equal(perm, np.arange(perm.size))
    for k, v in batch.items():
        want = v[torch.as_tensor(perm)] if v.shape[0] == batch["x"].shape[0] else v
        assert torch.equal(again[k], want), k


@pytest.mark.parametrize("route", ["autograd", "exact", "relaxed", "stale", "no_bias_grad"])
def test_sweep_routes_its_steps(route, monkeypatch):
    """`sweep` hands train_beta_sweep the route's step (and its reordered
    batch) and restores the trainer's own afterwards."""
    seen = []
    orig = beta_sweep.make_fused_value_and_grad, beta_sweep.make_batch

    def fake(spec, betas, **kw):
        vag = beta_sweep.make_fused_value_and_grad(spec, device="cpu")
        seen.append((vag, beta_sweep.make_batch(spec, 0, device="cpu")))
        return "ran"

    monkeypatch.setattr(beta_sweep, "train_beta_sweep", fake)
    assert sc.sweep(route, "cpu", reorder=True) == "ran"
    vag, batch = seen[0]
    assert (vag is None) == (route == "autograd")
    assert route in ("autograd", "exact") or getattr(vag, "stateful", False)
    assert torch.equal(batch["x"], sc.reordered(make_batch(EXPERIMENTS[sc.CONFIG].spec, 0,
                                                           device="cpu"))["x"])
    assert (beta_sweep.make_fused_value_and_grad, beta_sweep.make_batch) == orig
