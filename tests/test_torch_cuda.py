"""The CUDA kernels against their plain versions on the card, and the
launch counters. Needs a CUDA device (each test skips without one); it
imports no JAX, so on a CUDA machine without JAX run it as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from gpe_tpu_torch.kernels import fused_grad as k2  # noqa: E402
from gpe_tpu_torch.kernels import fused_residual as k1  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402


def _grads_close(got, want, atol=2e-4):
    for li, ((gw, gb), (ww, wb)) in enumerate(zip(got, want)):
        for a, b, what in ((gw, ww, "W"), (gb, wb, "b")):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            s = np.max(np.abs(b)) + 1e-12
            np.testing.assert_allclose(a / s, b / s, atol=atol,
                                       err_msg=f"{what} grad layer {li}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels exist only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("layers,n", [((2, 64, 64, 1), 1000),
                                      ((1, 48, 40, 1), 777),
                                      ((3, 32, 32, 1), 500),
                                      ((2, 64, 1), 300),
                                      ((2, 64, 64, 64, 64, 1), 600),
                                      ((2, 128, 128, 128, 1), 4096)])
def test_kernels_match_plain_on_the_card(cuda_device, layers, n):
    """Each CUDA kernel against its plain version on the same CUDA tensors:
    ragged tails, d = 1..3, widths below 128, no hidden GEMM layer, K1's
    streamed-weight path (3 hidden GEMMs) and the main path's net."""
    rng = np.random.default_rng(0)
    d = layers[0]
    params = params_from_numpy(
        [(rng.normal(0.0, 1.0 / np.sqrt(k), (k, m)), rng.normal(0.0, 0.1, m))
         for k, m in zip(layers[:-1], layers[1:])], device=cuda_device)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
    x = t(rng.uniform(-5.0, 5.0, (n, d)))
    V, w = t(rng.uniform(0.0, 10.0, n)), t(np.full(n, 0.01))
    bval, blap = t(rng.normal(0.0, 0.3, n)), t(rng.normal(0.0, 0.3, n))
    phys = ("shifted_tanh", 3.0, 0.5, "abs_power")
    got = k1.collocation_sums(params, x, V, w, 5.0, 0.05, bval, blap, *phys)
    want = k1.collocation_sums_plain(params, x, V, w, 5.0, 0.05, bval, blap, *phys)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)
    cots = torch.tensor([1e-3, -2e-3, 1e-3, 0.5], device=cuda_device)
    grads, sums = k2.collocation_grads(params, x, V, w, 5.0, 0.05, cots, bval,
                                       blap, *phys)
    pgrads, _ = k2.collocation_grads_plain(params, x, V, w, 5.0, 0.05, cots, bval,
                                           blap, *phys)
    np.testing.assert_allclose(sums.cpu().numpy(), got.cpu().numpy(), rtol=1e-6)
    _grads_close(grads, pgrads)


def test_wrappers_count_launches_and_fused_training_uses_both(cuda_device,
                                                              monkeypatch):
    """On the card the fused gate returns the kernel path; the exact step
    launches K1 and K2 once each and the relaxed step K2 only, and the
    counters move only where a kernel launches."""
    from gpe_tpu_torch.train.loop import fit
    from gpe_tpu_torch.train.plpinn import ramp_optimizer

    monkeypatch.delenv("GPE_TPU_TORCH_NO_FUSED", raising=False)
    spec = tprob.GPESpec(dim=2, n_points=40, layers=(2, 32, 32, 1), lb=-6.0,
                         ub=6.0, potential_kwargs=(("a", 0.5),), kinetic=0.5,
                         nonlinearity="abs_power")
    batch = tprob.make_batch(spec, 0, device=cuda_device)
    params = tprob.init_params(spec, torch.Generator().manual_seed(0),
                               device=cuda_device)
    loss_fn = tprob.make_loss_fn(spec)
    for relaxed, k1_launches in ((False, 12), (True, 1)):   # relaxed: init_state
        vag = tprob.make_fused_value_and_grad(spec, device=cuda_device,
                                              relaxed=relaxed)
        assert vag is not None
        k1.collocation_sums.launches = 0
        k2.collocation_grads.launches = 0
        res = fit(loss_fn, ramp_optimizer(), params, batch, 1.0, 0.05,
                  epochs=12, tol=-1.0, patience=10 ** 9, check_every=5,
                  value_and_grad_fn=vag)
        assert np.all(np.isfinite(res.loss_history))
        assert k2.collocation_grads.launches == 12
        assert k1.collocation_sums.launches == k1_launches
        ref = fit(loss_fn, ramp_optimizer(), params, batch, 1.0, 0.05, epochs=12,
                  tol=-1.0, patience=10 ** 9, check_every=5)
        np.testing.assert_allclose(res.loss_history[:1], ref.loss_history[:1],
                                   rtol=1e-4)
