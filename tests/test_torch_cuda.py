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
from gpe_tpu_torch.kernels import rowcat_eval as k4  # noqa: E402
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
                                      ((2, 128, 128, 128, 1), 4096),
                                      ((2, 100, 100, 100, 1), 3000),
                                      ((2, 100, 36, 1), 1500)])
def test_kernels_match_plain_on_the_card(cuda_device, layers, n):
    """Each CUDA kernel against its plain version on the same CUDA tensors:
    ragged tails, d = 1..3, widths below 128, no hidden GEMM layer, K1's
    streamed-weight path and K2's own forward loop (3 hidden GEMMs), the main
    path's net, the bench's width 100 and, in the tensor-core GEMMs (K1's
    forward, K2's reverse), widths that are not multiples of 8 (100 → 36)
    next to ones that are, and widths ≤ 64 (32 x 32 warp blocks) next to
    wider ones. K2's sums against K1's: rtol 1e-6, not bit-equality — K2's
    forward GEMMs are FFMA, K1's 3xTF32, so the two agree to f32 round-off."""
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


def _run_inputs(layers, n, R, per_run, device, seed=0):
    rng = np.random.default_rng(seed)
    d = layers[0]
    params = params_from_numpy(
        [(rng.normal(0.0, 1.0 / np.sqrt(k), (R, k, m)), rng.normal(0.0, 0.1, (R, m)))
         for k, m in zip(layers[:-1], layers[1:])], device=device)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    shape = (R, n) if per_run else (n,)
    return dict(params=params, x=t(rng.uniform(-5.0, 5.0, (n, d))),
                V=t(rng.uniform(0.0, 10.0, n)), w=t(np.full(n, 0.01)),
                bval=t(rng.normal(0.0, 0.3, shape)), blap=t(rng.normal(0.0, 0.3, shape)),
                gammas=t(rng.uniform(0.0, 5.0, R)), scales=t(rng.uniform(0.01, 0.1, R)),
                cots=t(np.stack([[1e-3, -2e-3, 1e-3, 0.5]] * R) * rng.uniform(0.5, 2.0, (R, 1))))


@pytest.mark.parametrize("layers,n,R,per_run", [((1, 64, 64, 64, 1), 4000, 6, True),
                                                ((1, 64, 64, 1), 4000, 6, False),
                                                ((1, 64, 64, 64, 64, 1), 4000, 6, True),
                                                ((1, 32, 32, 1), 777, 8, True),
                                                ((2, 64, 64, 1), 1000, 2, False),
                                                ((2, 32, 32, 32, 1), 501, 3, True),
                                                ((1, 64, 1), 300, 4, True)])
def test_run_kernels_match_plain_and_single_runs_on_the_card(cuda_device, layers, n,
                                                             R, per_run):
    """The run-mode K1/K2 (K3) against their plain versions and against R
    single-run launches, which they equal bit for bit (the same tile walk
    and reduction order per run): d = 1 and 2, widths 32 and 64, R = 2–8,
    ragged n, shared and per-run bases, power nonlinearity with u < 0. At
    n = 4000, d = 1 each of the 6·96 items is one tile, so a block's items
    cross from one run to the next and K1 stages weights per run, not per
    item; the 3-hidden-GEMM net streams them per layer instead. K2's sums
    against K1's: rtol 1e-6 (FFMA forward against 3xTF32, not bit-equal)."""
    from gpe_tpu_torch.models.mlp import run_slice

    a = _run_inputs(layers, n, R, per_run, cuda_device)
    phys = ("shifted_tanh", 3.0, 1.0, "power")
    args = (a["params"], a["x"], a["V"], a["w"], a["gammas"], a["scales"])
    base = (a["bval"], a["blap"])
    row = (lambda t, r: t[r]) if per_run else (lambda t, r: t)
    got = k1.collocation_sums_runs(*args, *base, *phys)
    want = k1.collocation_sums_runs_plain(*args, *base, *phys)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)
    grads, sums = k2.collocation_grads_runs(*args, a["cots"], *base, *phys)
    pgrads, _ = k2.collocation_grads_runs_plain(*args, a["cots"], *base, *phys)
    np.testing.assert_allclose(sums.cpu().numpy(), got.cpu().numpy(), rtol=1e-6)
    for r in range(R):
        _grads_close(run_slice(grads, r), run_slice(pgrads, r))
        one_args = (run_slice(a["params"], r), a["x"], a["V"], a["w"], a["gammas"][r],
                    a["scales"][r])
        one_base = (row(a["bval"], r), row(a["blap"], r))
        assert torch.equal(got[r], k1.collocation_sums(*one_args, *one_base, *phys))
        g1, s1 = k2.collocation_grads(*one_args, a["cots"][r], *one_base, *phys)
        assert torch.equal(sums[r], s1)
        for (gw, gb), (ow, ob) in zip(run_slice(grads, r), g1):
            assert torch.equal(gw, ow) and torch.equal(gb, ob)


def test_packed_fit_launches_each_run_kernel_once_per_step(cuda_device, monkeypatch):
    """On the card the packed gate returns the run-mode path; an exact fit
    launches each run-mode kernel once per step (K1 once more for μ at the
    restored params) and leaves the single-run counters alone."""
    from gpe_tpu_torch.train import packed

    monkeypatch.delenv("GPE_TPU_TORCH_NO_FUSED", raising=False)
    monkeypatch.delenv("GPE_TPU_TORCH_NO_PACKED", raising=False)
    monkeypatch.delenv("GPE_TPU_TORCH_RELAXED_FUSED", raising=False)
    spec = tprob.GPESpec(n_points=500, layers=(1, 32, 32, 1), activation="tanh")
    assert packed.packed_runs_available(spec, 4, device=cuda_device) == 4
    batch = tprob.make_batch(spec, 0, device=cuda_device)
    params = _run_inputs(spec.layers, 10, 4, False, cuda_device)["params"]
    for c in (k1.collocation_sums, k2.collocation_grads, k1.collocation_sums_runs,
              k2.collocation_grads_runs):
        c.launches = 0
    res = packed.fit_ensemble_packed(spec, params, batch, 1.0, 0.05, epochs=12,
                                     tol=-1.0, patience=10 ** 9, check_every=5)
    assert np.all(np.isfinite(res.loss_history)) and res.loss_history.shape == (4, 12)
    assert k2.collocation_grads_runs.launches == 12
    assert k1.collocation_sums_runs.launches == 13
    assert k1.collocation_sums.launches == k2.collocation_grads.launches == 0


def _inputs(layers, n, device, seed=0, w_scale=1.0):
    rng = np.random.default_rng(seed)
    params = params_from_numpy(
        [(w_scale * rng.normal(0.0, 1.0 / np.sqrt(k), (k, m)), rng.normal(0.0, 0.1, m))
         for k, m in zip(layers[:-1], layers[1:])], device=device)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return (params, t(rng.uniform(-5.0, 5.0, (n, layers[0]))),
            t(rng.uniform(0.0, 10.0, n)), t(np.full(n, 0.01)),
            t(rng.normal(0.0, 0.3, n)), t(rng.normal(0.0, 0.3, n)))


K4_CASES = [((2, 100, 100, 100, 1), 3000), ((1, 64, 64, 64, 1), 1000),
            ((3, 32, 32, 1), 500), ((2, 64, 1), 300), ((2, 128, 128, 128, 1), 4096),
            ((1, 48, 40, 40, 40, 1), 777)]


@pytest.mark.parametrize("layers,n", K4_CASES)
def test_k4_matches_plain_and_k1_on_the_card(cuda_device, layers, n):
    """K4 against its plain version and against K1 on the same inputs, f32
    (rel 1e-4: other summation order), with base streams, d = 1..3, ragged n,
    no hidden GEMM layer, one resident and several streamed weight layers."""
    params, x, V, w, bval, blap = _inputs(layers, n, cuda_device)
    for phys, base in ((("shifted_tanh", 3.0, 0.5, "abs_power"), (bval, blap)),
                       (("tanh", 3.0, 1.0, "power"), (None, None))):
        got = k4.collocation_sums(params, x, V, w, 5.0, 0.05, *base, *phys)
        want = k4.collocation_sums_plain(params, x, V, w, 5.0, 0.05, *base, *phys)
        ref = k1.collocation_sums(params, x, V, w, 5.0, 0.05, *base, *phys)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4)


@pytest.mark.parametrize("layers,n", K4_CASES)
def test_bf16_operand_modes_match_their_plain_versions_on_the_card(cuda_device,
                                                                  layers, n):
    """K1 and K4 with bf16 GEMM operands (bf16 tensor-core hidden GEMMs)
    against the bf16 plain version (rel 1e-4, K1's f32 limit: both round the
    same operands; an f32 value within f32 round-off of a bf16 rounding
    boundary may round the other way, a 2^-8 change of one term), and within
    the bench's 0.1 of the f32 sums: widths 32–128, contraction tails of 4
    (width 100) and 8 (width 40), d = 1..3, ragged n, no, one or several
    hidden GEMM layers (K1 streams the weights of three)."""
    params, x, V, w, bval, blap = _inputs(layers, n, cuda_device)
    phys = ("shifted_tanh", 3.0, 0.5, "abs_power")
    bf16 = torch.bfloat16
    want = k1.collocation_sums_plain(params, x, V, w, 5.0, 0.05, bval, blap, *phys,
                                     compute_dtype=bf16).cpu().numpy()
    f32 = k1.collocation_sums_plain(params, x, V, w, 5.0, 0.05, bval, blap,
                                    *phys).cpu().numpy()
    for mod in (k1, k4):
        got = mod.collocation_sums(params, x, V, w, 5.0, 0.05, bval, blap, *phys,
                                   compute_dtype=bf16).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4)
        np.testing.assert_allclose(got, f32, rtol=0.1)
        assert not np.array_equal(got, f32)


@pytest.mark.parametrize("mod", [k1, k4], ids=["K1", "K4"])
def test_bf16_operand_modes_keep_parity_at_weights_x4(cuda_device, mod):
    """K1 and K4 with bf16 operands and weights scaled x4 against the bf16
    plain version, rel 1e-4 per sum as the f32 x4 tests: at the bench's width
    100 (a contraction tail of 4), where saturated activations make the
    sums most sensitive to the tensor cores' other order of the f32 sums."""
    params, x, V, w, bval, blap = _inputs((2, 100, 100, 100, 1), 3000, cuda_device,
                                          w_scale=4.0)
    args = (params, x, V, w, 5.0, 0.05, bval, blap, "shifted_tanh", 3.0, 0.5,
            "abs_power")
    got = mod.collocation_sums(*args, compute_dtype=torch.bfloat16)
    want = mod.collocation_sums_plain(*args, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


def test_k4_eval_refuses_ragged_counts_and_counts_launches(cuda_device):
    """make_rowcat_loss_eval keeps JAX's tile contract (a count the tile does
    not divide is refused, a divisible one matches K1's eval), and K4's
    counters move once per launch, per operand type."""
    from gpe_tpu_torch.bench import bench_spec
    from gpe_tpu_torch.models.mlp import init_mlp

    spec = bench_spec(n_side=64, layers=(2, 100, 100, 100, 1))
    batch = tprob.make_batch(spec, 0, device=cuda_device)
    params = init_mlp(spec.layers, generator=torch.Generator().manual_seed(0),
                      device=cuda_device)
    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    with pytest.raises(ValueError, match="divisible"):
        k4.make_rowcat_loss_eval(spec.layers, **kw, tile=1792)(params, batch,
                                                                100.0, 0.01)
    k4.collocation_sums.launches = k4.collocation_sums.bf16_launches = 0
    ev4 = k4.make_rowcat_loss_eval(spec.layers, **kw, tile=512)
    ev1 = k1.make_loss_eval(spec.layers, **kw)
    tot4, aux4 = ev4(params, batch, 100.0, 0.01)
    tot1, _ = ev1(params, batch, 100.0, 0.01)
    np.testing.assert_allclose(float(tot4), float(tot1), rtol=1e-4)
    k4.make_rowcat_loss_eval(spec.layers, **kw, tile=512,
                             compute_dtype=torch.bfloat16)(params, batch, 100.0, 0.01)
    assert (k4.collocation_sums.launches, k4.collocation_sums.bf16_launches) == (1, 1)
    k4.collocation_sums_plain(params, batch["x"], batch["V"], batch["w"], 1.0, 0.1, **kw)
    assert (k4.collocation_sums.launches, k4.collocation_sums.bf16_launches) == (1, 1)


@pytest.mark.parametrize("layers,n", [((2, 100, 100, 100, 1), 3000),
                                      ((2, 128, 128, 128, 1), 4096)])
def test_k4_split_tf32_keeps_f32_parity(cuda_device, layers, n):
    """K4 f32 with weights scaled x4 against its plain version, rel 1e-4 per
    sum: its hidden GEMMs run in 3xTF32 on 64 x 64 warp blocks, and
    saturated activations make the sums most sensitive to the products'
    error (PERF.md has what one TF32 product per f32 product,
    k4_variants.py's tf32x1, reads here)."""
    params, x, V, w, bval, blap = _inputs(layers, n, cuda_device, w_scale=4.0)
    args = (params, x, V, w, 5.0, 0.05, bval, blap, "shifted_tanh", 3.0, 0.5,
            "abs_power")
    got, want = k4.collocation_sums(*args), k4.collocation_sums_plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


# Weights x4: there a reverse pass with one TF32 term per product misses
# _grads_close's 2e-4; the 3xTF32 split keeps K2 within it (PERF.md has both
# errors).
K2_SPLIT_CASES = [((2, 128, 128, 128, 1), 4096), ((1, 64, 64, 64, 1), 4000)]


@pytest.mark.parametrize("layers,n", K2_SPLIT_CASES)
def test_k2_split_tf32_reverse_pass_keeps_f32_parity(cuda_device, layers, n):
    """K2 with weights scaled x4 against its plain version (normalised 2e-4),
    its sums against K1's (rtol 1e-6: K2's forward is FFMA, K1's 3xTF32)."""
    params, x, V, w, bval, blap = _inputs(layers, n, cuda_device, w_scale=4.0)
    phys = ("shifted_tanh", 3.0, 0.5, "abs_power")
    sums = k1.collocation_sums(params, x, V, w, 5.0, 0.05, bval, blap, *phys)
    cots = k1.sums_to_loss(sums, n, 20.0)[3]
    grads, s2 = k2.collocation_grads(params, x, V, w, 5.0, 0.05, cots, bval, blap,
                                     *phys)
    pgrads, _ = k2.collocation_grads_plain(params, x, V, w, 5.0, 0.05, cots, bval,
                                           blap, *phys)
    np.testing.assert_allclose(s2.cpu().numpy(), sums.cpu().numpy(), rtol=1e-6)
    _grads_close(grads, pgrads)


@pytest.mark.parametrize("layers,R", [((2, 128, 128, 128, 1), None),
                                      ((1, 64, 64, 64, 1), 6),
                                      ((3, 100, 36, 1), 2),
                                      ((2, 48, 40, 40, 40, 1), None),
                                      ((2, 64, 1), 3)])
def test_layout_kernel_matches_its_plain_version(cuda_device, layers, R):
    """K2's layout kernel (the padded W_l and W_lᵀ copies the gradient kernel
    stages) equals padded_weights_plain bit for bit."""
    lead = () if R is None else (R,)
    rng = np.random.default_rng(1)
    params = params_from_numpy(
        [(rng.normal(size=lead + (k, m)), rng.normal(size=lead + (m,)))
         for k, m in zip(layers[:-1], layers[1:])], device=cuda_device)
    got = k2.padded_weights(params, R)
    want = k2.padded_weights_plain(params, R)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("layers,n,R", [((2, 128, 128, 128, 1), 4096, None),
                                        ((1, 64, 64, 64, 1), 4000, None),
                                        ((1, 64, 64, 64, 1), 4000, 6)])
def test_k1_split_tf32_forward_keeps_f32_parity(cuda_device, layers, n, R):
    """K1 and K3 sums with weights scaled x4 against their plain versions,
    rel 1e-4 per sum (K1_TOL): K1's forward GEMMs run in 3xTF32, and with one
    TF32 product per f32 product (k1_variants.py's tf32x1) these sums miss
    1e-4 (PERF.md: 1.5e-4, 4.0e-4 and 3.5e-3), so the test guards the split."""
    rng = np.random.default_rng(0)
    lead = () if R is None else (R,)
    params = params_from_numpy(
        [(4.0 * rng.normal(0.0, 1.0 / np.sqrt(k), lead + (k, m)),
          rng.normal(0.0, 0.1, lead + (m,))) for k, m in zip(layers[:-1], layers[1:])],
        device=cuda_device)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
    x = t(rng.uniform(-5.0, 5.0, (n, layers[0])))
    V, w = t(rng.uniform(0.0, 10.0, n)), t(np.full(n, 0.01))
    bval, blap = t(rng.normal(0.0, 0.3, lead + (n,))), t(rng.normal(0.0, 0.3, lead + (n,)))
    phys = ("shifted_tanh", 3.0, 0.5, "abs_power")
    if R is None:
        args = (params, x, V, w, 5.0, 0.05, bval, blap, *phys)
        got, want = k1.collocation_sums(*args), k1.collocation_sums_plain(*args)
    else:
        args = (params, x, V, w, torch.linspace(0.0, 5.0, R, device=cuda_device),
                torch.linspace(0.01, 0.1, R, device=cuda_device), bval, blap, *phys)
        got, want = k1.collocation_sums_runs(*args), k1.collocation_sums_runs_plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)


@pytest.mark.parametrize("mode,gamma,scale", [(0, 0.0, 0.01), (1, 5.0, 0.05),
                                              (5, 100.0, 0.01)])
def test_kernels_on_the_gravity_well_batch(cuda_device, mode, gamma, scale):
    """K1 and K2 on `gravity_well_paper`'s batch (4,000 points on [0, 35],
    lb = 0, the linear potential, the Airy base and its Laplacian from the
    device table) against their plain versions: sums rel 1e-4, gradients
    normalised 2e-4; the fused step goes through both kernels."""
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS

    spec = EXPERIMENTS["gravity_well_paper"].spec
    batch = tprob.make_batch(spec, mode, device=cuda_device)
    assert float(batch["x"][0, 0]) == 0.0 and abs(float(batch["base_val"][0])) < 1e-5
    rng = np.random.default_rng(mode)
    params = params_from_numpy(
        [(rng.normal(0.0, 1.0 / np.sqrt(k), (k, m)), rng.normal(0.0, 0.1, m))
         for k, m in zip(spec.layers[:-1], spec.layers[1:])], device=cuda_device)
    phys = (spec.activation, spec.p, spec.kinetic, spec.nonlinearity)
    args = (params, batch["x"], batch["V"], batch["w"], gamma, scale)
    base = (batch["base_val"], batch["base_lap"])
    got = k1.collocation_sums(*args, *base, *phys)
    want = k1.collocation_sums_plain(*args, *base, *phys)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)
    cots = k1.sums_to_loss(got, batch["x"].shape[0], spec.norm_weight)[3]
    grads, sums = k2.collocation_grads(*args, cots, *base, *phys)
    pgrads, _ = k2.collocation_grads_plain(*args, cots, *base, *phys)
    np.testing.assert_allclose(sums.cpu().numpy(), got.cpu().numpy(), rtol=1e-4)
    _grads_close(grads, pgrads)
    vag = tprob.make_fused_value_and_grad(spec, device=cuda_device, relaxed=False)
    before = (k1.collocation_sums.launches, k2.collocation_grads.launches)
    (total, aux), _ = vag(params, batch, gamma, scale)
    assert (k1.collocation_sums.launches - before[0],
            k2.collocation_grads.launches - before[1]) == (1, 1)
    ref, raux = tprob.make_loss_fn(spec)(params, batch, gamma, scale)
    np.testing.assert_allclose(float(aux["mu"]), float(raux["mu"]), rtol=1e-4)


@pytest.mark.parametrize("beta", [1.0, 20.0, 100.0])
def test_relaxed_vag_at_a_rescaled_potential(cuda_device, monkeypatch, beta):
    """vary_beta_gravity_well's batch with its unit potential scaled by β
    on the host (`beta_sweep.beta_scaled`, up to V = 100·x): K1 and K2
    against their plain versions (sums rel 1e-4, gradients normalised
    2e-4), and the default relaxed fused step through `fit` — one K1 for
    its initial state, one K2 a step — whose first reported μ is autograd's
    at the same params (rtol 1e-4)."""
    from gpe_tpu_torch.experiments.configs import EXPERIMENTS
    from gpe_tpu_torch.train.beta_sweep import beta_scaled
    from gpe_tpu_torch.train.loop import fit
    from gpe_tpu_torch.train.optimizers import make_optimizer

    for var in ("GPE_TPU_TORCH_NO_FUSED", "GPE_TPU_TORCH_NO_RELAXED",
                "GPE_TPU_TORCH_RELAXED_FUSED"):
        monkeypatch.delenv(var, raising=False)
    spec = EXPERIMENTS["vary_beta_gravity_well"].spec
    batch = beta_scaled(tprob.make_batch(spec, 0, device=cuda_device), beta)
    rng = np.random.default_rng(int(beta))
    params = params_from_numpy(
        [(rng.normal(0.0, 1.0 / np.sqrt(k), (k, m)), rng.normal(0.0, 0.1, m))
         for k, m in zip(spec.layers[:-1], spec.layers[1:])], device=cuda_device)
    phys = (spec.activation, spec.p, spec.kinetic, spec.nonlinearity)
    args = (params, batch["x"], batch["V"], batch["w"], 0.0, 0.01)
    base = (batch["base_val"], batch["base_lap"])
    got = k1.collocation_sums(*args, *base, *phys)
    want = k1.collocation_sums_plain(*args, *base, *phys)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)
    cots = k1.sums_to_loss(got, batch["x"].shape[0], spec.norm_weight)[3]
    grads, _ = k2.collocation_grads(*args, cots, *base, *phys)
    _grads_close(grads, k2.collocation_grads_plain(*args, cots, *base, *phys)[0])
    vag = tprob.make_fused_value_and_grad(spec, device=cuda_device)
    assert vag is not None and vag.stateful
    k1.collocation_sums.launches = 0
    k2.collocation_grads.launches = 0
    opt = make_optimizer("adam", 1e-3, clip_norm=1.0)
    res = fit(tprob.make_loss_fn(spec), opt, params, batch, 0.0, 0.01, epochs=20,
              tol=-1.0, patience=10 ** 9, check_every=10, value_and_grad_fn=vag)
    assert (k1.collocation_sums.launches, k2.collocation_grads.launches) == (1, 20)
    assert np.all(np.isfinite(res.loss_history)) and np.all(np.isfinite(res.mu_history))
    _, aux = tprob.make_loss_fn(spec)(params, batch, 0.0, 0.01)
    np.testing.assert_allclose(res.mu_history[0], float(aux["mu"]), rtol=1e-4)


def _ensemble_case(R, per_run_gamma, device):
    """A 1,000-point harmonic trap, [1,32,32,1] shifted_tanh, R run-stacked
    nets of numpy seeds with per-run q-scales; γ 20, or 0…100 per run."""
    from gpe_tpu_torch.models.mlp import stack_runs

    spec = tprob.GPESpec(n_points=1000, layers=(1, 32, 32, 1))
    batch = tprob.make_batch(spec, 0, device=device)
    runs = [_inputs(spec.layers, 1, device, seed=40 + r, w_scale=0.5)[0]
            for r in range(R)]
    gammas = [20.0 * r for r in range(R)] if per_run_gamma else 20.0
    scales = [0.01 * (1 + r) for r in range(R)]
    return spec, batch, stack_runs(runs), runs, gammas, scales


@pytest.mark.parametrize("R,per_run_gamma", [(5, False), (6, True)])
def test_fit_ensemble_fused_route_matches_single_fits(cuda_device, monkeypatch, R,
                                                      per_run_gamma):
    """fit_ensemble with the default (relaxed) fused vag steps all runs
    with one run-mode K2 (K3 grads) launch per step and one run-mode K1 for
    its initial state, and no single-run launch; its histories match R
    single-run fused fits (loss rtol 1e-4, μ 1e-5)."""
    from gpe_tpu_torch.train.loop import fit, fit_ensemble
    from gpe_tpu_torch.train.plpinn import ramp_optimizer

    for var in ("GPE_TPU_TORCH_NO_FUSED", "GPE_TPU_TORCH_NO_RELAXED",
                "GPE_TPU_TORCH_RELAXED_FUSED"):
        monkeypatch.delenv(var, raising=False)
    spec, batch, pb, runs, gammas, scales = _ensemble_case(R, per_run_gamma, cuda_device)
    vag = tprob.make_fused_value_and_grad(spec, device=cuda_device)
    loss_fn = tprob.make_loss_fn(spec)
    kw = dict(epochs=40, tol=0.0, patience=10 ** 9, check_every=20)
    counters = (k1.collocation_sums, k2.collocation_grads, k1.collocation_sums_runs,
                k2.collocation_grads_runs)
    for c in counters:
        c.launches = 0
    ens = fit_ensemble(loss_fn, ramp_optimizer(1e-3), pb, batch, gammas, scales,
                       value_and_grad_fn=vag, **kw)
    assert [c.launches for c in counters] == [0, 0, 1, 40]
    g = gammas if per_run_gamma else [gammas] * R
    for r in range(R):
        one = fit(loss_fn, ramp_optimizer(1e-3), runs[r], batch, g[r], scales[r],
                  value_and_grad_fn=vag, **kw)
        np.testing.assert_allclose(ens.loss_history[r], one.loss_history, rtol=1e-4)
        np.testing.assert_allclose(ens.mu_history[r], one.mu_history, rtol=1e-5)
        np.testing.assert_allclose(ens.mu_best[r], one.mu_best, rtol=1e-5)


@pytest.mark.parametrize("R,per_run_gamma", [(5, False), (6, True)])
def test_fit_ensemble_fused_route_matches_the_plain_route(cuda_device, monkeypatch, R,
                                                          per_run_gamma):
    """The fused route with the exact step (K3 sums and grads each step)
    against the plain route (torch.func over autograd of the loss) on the
    card: μ histories rtol 1e-5. The fused loss is built from the four
    sums, whose pde term (S₀ − 2μS₁ + μ²S₂)/N cancels digits, so loss
    histories are held at 1e-3 (4.4e-4 measured with the kernels' plain
    versions on the CPU)."""
    from gpe_tpu_torch.train.loop import fit_ensemble
    from gpe_tpu_torch.train.plpinn import ramp_optimizer

    monkeypatch.delenv("GPE_TPU_TORCH_NO_FUSED", raising=False)
    spec, batch, pb, _, gammas, scales = _ensemble_case(R, per_run_gamma, cuda_device)
    vag = tprob.make_fused_value_and_grad(spec, device=cuda_device, relaxed=False)
    loss_fn = tprob.make_loss_fn(spec)
    kw = dict(epochs=40, tol=0.0, patience=10 ** 9, check_every=20)
    before = k2.collocation_grads_runs.launches
    fused = fit_ensemble(loss_fn, ramp_optimizer(1e-3), pb, batch, gammas, scales,
                         value_and_grad_fn=vag, **kw)
    assert k2.collocation_grads_runs.launches - before == 40
    plain = fit_ensemble(loss_fn, ramp_optimizer(1e-3), pb, batch, gammas, scales, **kw)
    np.testing.assert_allclose(fused.mu_history, plain.mu_history, rtol=1e-5)
    np.testing.assert_allclose(fused.loss_history, plain.loss_history, rtol=1e-3)


def test_lm_graphed_matvec_matches_the_eager_one(cuda_device):
    """The LM solver's CUDA-graph CG matvec against the op-by-op one on the
    card: 6 LM steps of a perturbation ansatz at γ = 20, loss histories
    rtol 1e-5 and the same accept/reject sequence of λ."""
    from gpe_tpu_torch.train.gauss_newton import make_gpe_residual_fn, make_lm_solver

    spec = tprob.GPESpec(n_points=1000, layers=(1, 32, 32, 1))
    batch = tprob.make_batch(spec, 0, device=cuda_device)
    params = _inputs(spec.layers, 1, cuda_device, seed=3, w_scale=0.5)[0]
    rfn = make_gpe_residual_fn(spec)
    out = [make_lm_solver(rfn, params, steps=6, cg_iters=40, graph=g)(
        params, batch, 20.0, 0.05) for g in (False, True)]
    np.testing.assert_allclose(out[1].loss_history, out[0].loss_history, rtol=1e-5)
    np.testing.assert_array_equal(out[1].lam_history, out[0].lam_history)


def test_pretrain_graphed_adam_steps_match_the_eager_ones(cuda_device):
    """pretrain_to_base's Adam steps replayed from a CUDA graph against the
    same steps launched op by op: 50 steps, the same params to rtol 1e-6."""
    from gpe_tpu_torch.models.mlp import mlp_apply
    from gpe_tpu_torch.train.pretrain import AdamSteps

    spec = tprob.GPESpec(n_points=1000, layers=(1, 32, 32, 1))
    batch = tprob.make_batch(spec, 1, device=cuda_device)
    params = _inputs(spec.layers, 1, cuda_device, seed=4)[0]
    out = []
    for graph in (False, True):
        leaves = [t.clone().requires_grad_(True) for pair in params for t in pair]
        pairs = tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))
        mse = lambda: torch.mean((mlp_apply(pairs, batch["x"], spec.activation)
                                  - batch["base_val"]) ** 2)
        AdamSteps(mse, leaves, 1e-3, graph).run(50)
        out.append([t.detach().cpu().numpy() for t in leaves])
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)


def _zoo_case(device, seed=0):
    """The GPE loss of a small 1D spec on `device` (the batch built on the
    CPU, then moved), a [1,32,32,32,1] net's params from numpy and a
    gradient of the same shapes."""
    spec = tprob.GPESpec(n_points=512, layers=(1, 32, 32, 32, 1), use_perturbation=True)
    batch = {k: v.to(device) for k, v in tprob.make_batch(spec, 0, device="cpu").items()}
    rng = np.random.default_rng(seed)
    shapes = list(zip(spec.layers[:-1], spec.layers[1:]))
    params = params_from_numpy([(rng.normal(0, 1 / np.sqrt(i), (i, o)), rng.normal(0, 0.1, o))
                                for i, o in shapes], device=device)
    grads = params_from_numpy([(rng.normal(0, 1, (i, o)), rng.normal(0, 1, o))
                               for i, o in shapes], device=device)
    loss_fn = tprob.make_loss_fn(spec)
    return params, grads, batch, lambda p: loss_fn(p, batch, 10.0, 1.3)[0]


def test_hessian_vector_product_on_the_card_matches_the_cpu(cuda_device):
    """Hutchinson's z ⊙ (H z) by double backward through the forward
    Laplacian on the card against the CPU, the same probe: rtol 1e-4 of
    each leaf's largest entry."""
    from torch.utils import _pytree as pytree

    from gpe_tpu_torch.device import pin_full_f32
    from gpe_tpu_torch.train.optimizers import hutchinson_diag, rademacher_like

    pin_full_f32()
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        params, _, _, obj = _zoo_case(dev)
        leaves, spec = pytree.tree_flatten(params)
        z = rademacher_like(leaves, torch.Generator().manual_seed(3))
        flat = lambda ls: obj(pytree.tree_unflatten(ls, spec))
        out.append([d.cpu().numpy() for d in hutchinson_diag(flat, leaves, z)])
    for b, a in zip(*out):
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("name,kw,steps", [("muon", {}, 1),
                                           ("shampoo", {"precondition_frequency": 40}, 40)])
def test_muon_and_shampoo_updates_on_the_card_match_the_cpu(cuda_device, name, kw, steps):
    """The same gradients on the card and on the CPU: muon's first update;
    shampoo's 40th, where its eigh roots are first refreshed, from
    statistics of full rank (random gradients of 40 steps). rtol 1e-5 of
    each leaf's largest entry (Newton–Schulz and the roots in full f32)."""
    from gpe_tpu_torch.device import pin_full_f32
    from gpe_tpu_torch.train.optimizers import make_optimizer

    pin_full_f32()
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        params, _, _, obj = _zoo_case(dev)
        opt = make_optimizer(name, 1e-3, clip_norm=1.0, **kw)
        state = opt.init(params)
        for step in range(steps):
            _, grads, _, _ = _zoo_case(dev, seed=step + 1)
            u, state = opt.update(grads, state, params, value=obj(params), obj_fn=obj,
                                  generator=torch.Generator().manual_seed(0))
        out.append([t.cpu().numpy() for pair in u for t in pair])
    for b, a in zip(*out):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def test_kernels_match_plain_at_the_3d_flagship_shape(cuda_device):
    """K1 and K2 at d = 3 on the 3D flagship's grid (36³ = 46,656 points,
    [3,128,128,128,1], γ 5, s 0.01) against their plain versions."""
    spec = tprob.GPESpec(dim=3, lb=-6.0, ub=6.0, n_points=36,
                         layers=(3, 128, 128, 128, 1), potential="harmonic",
                         potential_kwargs=(("a", 0.5),), kinetic=0.5,
                         nonlinearity="abs_power", basis="hermite")
    batch = tprob.make_batch(spec, 0, device=cuda_device)
    rng = np.random.default_rng(3)
    params = params_from_numpy(
        [(rng.normal(0.0, 1.0 / np.sqrt(k), (k, m)), rng.normal(0.0, 0.1, m))
         for k, m in zip(spec.layers[:-1], spec.layers[1:])], device=cuda_device)
    args = (params, batch["x"], batch["V"], batch["w"], 5.0, 0.01)
    base = (batch["base_val"], batch["base_lap"])
    phys = (spec.activation, spec.p, spec.kinetic, spec.nonlinearity)
    got = k1.collocation_sums(*args, *base, *phys)
    want = k1.collocation_sums_plain(*args, *base, *phys)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4)
    cots = k1.sums_to_loss(got, batch["x"].shape[0], spec.norm_weight)[3]
    grads, sums = k2.collocation_grads(*args, cots, *base, *phys)
    pgrads, _ = k2.collocation_grads_plain(*args, cots, *base, *phys)
    np.testing.assert_allclose(sums.cpu().numpy(), got.cpu().numpy(), rtol=1e-4)
    _grads_close(grads, pgrads)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_dst1_card_matches_cpu(cuda_device, dtype, tol):
    from gpe_tpu_torch.train.spectral_flow import dst1

    a = torch.as_tensor(np.random.default_rng(0).normal(size=(9, 30, 17)), dtype=dtype)
    for axis in (0, 1, 2):
        got = dst1(a.to(cuda_device), axis).cpu()
        np.testing.assert_allclose(got.numpy(), dst1(a, axis).numpy(), atol=tol)
        np.testing.assert_allclose(dst1(dst1(a.to(cuda_device), axis), axis).cpu().numpy(),
                                   a.numpy(), atol=tol)


@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
def test_flow_interleave_block_card_matches_cpu(cuda_device, bc):
    """One outer step of the spectral-flow interleave (a flow block, the
    grid μ, 20 graphed Adam steps) on the card against the CPU: the grid μ
    at rtol 1e-6 (one f32 block), the fit loss at 1e-4 (f32 Adam)."""
    from gpe_tpu_torch.train.spectral_flow import make_spectral_flow_solver

    spec = tprob.GPESpec(dim=2, n_points=48, layers=(2, 32, 32, 1), lb=-8.0, ub=8.0,
                         potential="harmonic", potential_kwargs=(("a", 0.5),), kinetic=0.5,
                         use_perturbation=False, nonlinearity="abs_power")
    batch = tprob.make_batch(spec, 0, device="cpu")
    rng = np.random.default_rng(1)
    init = [(rng.normal(0.0, 1.0 / np.sqrt(k), (k, m)), rng.normal(0.0, 0.1, m))
            for k, m in zip(spec.layers[:-1], spec.layers[1:])]
    solver = make_spectral_flow_solver(spec, outer_steps=1, inner_steps=20,
                                       final_inner_steps=1, final_lbfgs_steps=0,
                                       endgame_steps=50, bc=bc)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        r = solver(params_from_numpy(init, device=dev),
                   {k: v.to(dev) for k, v in batch.items()}, 5.0)
        out[dev.type] = r
    np.testing.assert_allclose(out["cuda"].mu_history[0], out["cpu"].mu_history[0], rtol=1e-6)
    np.testing.assert_allclose(out["cuda"].fit_history[0], out["cpu"].fit_history[0],
                               rtol=1e-4)


def test_adam_steps_graph_refill_matches_eager(cuda_device):
    """AdamSteps across calls, graphed, with its target buffer refilled
    between calls (the interleave's use) against the same steps op by op."""
    from gpe_tpu_torch.models.mlp import mlp_apply
    from gpe_tpu_torch.train.pretrain import AdamSteps

    spec = tprob.GPESpec(n_points=1000, layers=(1, 32, 32, 1))
    batch = tprob.make_batch(spec, 1, device=cuda_device)
    rng = np.random.default_rng(5)
    init = params_from_numpy([(rng.normal(0, 0.5, (k, m)), rng.normal(0, 0.1, m))
                              for k, m in zip(spec.layers[:-1], spec.layers[1:])],
                             device=cuda_device)
    out = []
    for graph in (False, True):
        leaves = [t.clone().requires_grad_(True) for pair in init for t in pair]
        pairs = tuple((leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2))
        target = torch.zeros_like(batch["base_val"])
        adam = AdamSteps(lambda: torch.mean((mlp_apply(pairs, batch["x"], spec.activation)
                                             - target) ** 2), leaves, 1e-3, graph)
        losses = []
        for k, n in enumerate((1, 3, 5, 4)):
            target.copy_(batch["base_val"] * (1.0 + 0.1 * k))
            losses.append(float(adam.run(n)))
        out.append((losses, [t.detach().cpu().numpy() for t in leaves]))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for a, b in zip(out[1][1], out[0][1]):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)


def test_deeponet_loss_gradient_card_matches_cpu(cuda_device):
    """The DeepONet loss and its gradient at full width (64 potentials ×
    512 points) in float64 on the card against the CPU (rtol 1e-10)."""
    from torch.utils import _pytree as pytree

    from gpe_tpu_torch.deeponet import model as don
    from gpe_tpu_torch.train.loop import value_and_grad

    spec = don.DeepONetSpec()
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        params = pytree.tree_map(lambda t: t.double(), don.init_deeponet(
            spec, torch.Generator().manual_seed(0), device=dev))
        batch = {k: v.double() for k, v in
                 don.make_potential_family_batch(spec, 64, device=dev).items()}
        one = torch.tensor(1.0, dtype=torch.float64, device=dev)
        (tot, aux), grads = value_and_grad(don.make_deeponet_loss(spec))(params, batch,
                                                                         one, one)
        out[dev.type] = (float(tot), [g.cpu().numpy() for g in pytree.tree_leaves(grads)])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-10)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        s = np.abs(b).max() + 1e-30
        np.testing.assert_allclose(a / s, b / s, rtol=0, atol=1e-10)


@pytest.mark.parametrize("layers,n,R", [((2, 128, 128, 128, 1), 4096, None),
                                        ((2, 100, 100, 100, 1), 3000, None),
                                        ((1, 48, 40, 1), 777, None),
                                        ((3, 32, 32, 1), 500, None),
                                        ((2, 64, 1), 300, None),
                                        ((2, 64, 64, 64, 64, 1), 600, None),
                                        ((1, 64, 64, 64, 1), 4000, 3),
                                        ((2, 100, 36, 1), 1500, 2)])
def test_k2_bf16_matches_its_plain_version_on_the_card(cuda_device, layers, n, R):
    """K2 (and, with R, K3 grads and K3 sums) in the bf16 operand mode
    against the bf16 plain versions: gradients normalised 2e-4, sums rel 1e-4
    (both round the same operands; a value within f32 round-off of a bf16
    boundary may round the other way); and apart from the f32 kernel's
    gradients, but within 5e-2 of them normalised. d = 1..3, ragged n, width
    100, no, one, two and three hidden GEMM layers (the deep forward), runs
    with per-run bases and γ."""
    bf16 = torch.bfloat16
    params, x, V, w, bval, blap = _inputs(layers, n, cuda_device)
    phys = ("shifted_tanh", 3.0, 0.5, "abs_power")
    gamma, scale = 5.0, 0.05
    cots = torch.tensor([1.0 / n, -4.0 / n, 4.0 / n, 0.3], device=cuda_device)
    if R is not None:
        stack = lambda t: torch.stack([t * (1.0 + 0.1 * r) for r in range(R)])
        params = tuple((stack(W), stack(b)) for W, b in params)
        bval, blap = stack(bval), stack(blap)
        gamma = torch.linspace(1.0, 5.0, R, device=cuda_device)
        scale = torch.full((R,), 0.05, device=cuda_device)
        cots = torch.stack([cots] * R)
        sums = k1.collocation_sums_runs(params, x, V, w, gamma, scale, bval, blap, *phys,
                                        compute_dtype=bf16)
        psums = k1.collocation_sums_runs_plain(params, x, V, w, gamma, scale, bval, blap,
                                               *phys, compute_dtype=bf16)
        np.testing.assert_allclose(sums.cpu().numpy(), psums.cpu().numpy(), rtol=1e-4)
        run = lambda fn, **kw: fn(params, x, V, w, gamma, scale, cots, bval, blap, *phys,
                                  **kw)
        got, s = run(k2.collocation_grads_runs, compute_dtype=bf16)
        want, ws = run(k2.collocation_grads_runs_bf16_plain)
        f32, _ = run(k2.collocation_grads_runs)
        for r in range(R):
            pick = lambda g: tuple((a[r], b[r]) for a, b in g)
            _grads_close(pick(got), pick(want))
            _grads_close(pick(got), pick(f32), atol=5e-2)
    else:
        run = lambda fn, **kw: fn(params, x, V, w, gamma, scale, cots, bval, blap, *phys,
                                  **kw)
        got, s = run(k2.collocation_grads, compute_dtype=bf16)
        want, ws = run(k2.collocation_grads_bf16_plain)
        f32, _ = run(k2.collocation_grads)
        _grads_close(got, want)
        _grads_close(got, f32, atol=5e-2)
        assert not all(torch.equal(a, b) for (a, _), (b, _) in zip(got, f32))
    np.testing.assert_allclose(s.cpu().numpy(), ws.cpu().numpy(), rtol=1e-4)


@pytest.mark.parametrize("layers,n,R", [((2, 128, 128, 128, 1), 4096, None),
                                        ((1, 64, 64, 64, 1), 4000, 6)])
def test_k2_bf16_keeps_parity_at_weights_x4(cuda_device, layers, n, R):
    """K2-bf16 (main width) and K3-grads-bf16 (six runs at width 64) with
    weights x4 against the bf16 plain version (normalised 2e-4, sums rel
    1e-4): the forward and backprop products of bf16 operands and f32
    weights, each weight as three bf16 terms, must keep f32 accuracy where
    saturated activations make the gradient most sensitive. A split that
    drops the third term fails here (k2_variants.py's bf16x2), and so does
    the three-term GEMM that chains its slabs through the tensor core's
    truncating accumulator (its mma_chain): the bias of that adder flips
    bf16 roundings of the next layer's state."""
    params, x, V, w, bval, blap = _inputs(layers, n, cuda_device, w_scale=4.0)
    cots = torch.tensor([2e-4, -8e-4, 8e-4, 0.3], device=cuda_device)
    gamma, scale = 5.0, 0.05
    grads_fn, plain_fn = k2.collocation_grads, k2.collocation_grads_bf16_plain
    if R is not None:
        stack = lambda t: torch.stack([t * (1.0 + 0.05 * r) for r in range(R)])
        params = tuple((stack(W), stack(b)) for W, b in params)
        bval, blap = stack(bval), stack(blap)
        gamma = torch.linspace(1.0, 5.0, R, device=cuda_device)
        scale = torch.full((R,), 0.05, device=cuda_device)
        cots = torch.stack([cots] * R)
        grads_fn, plain_fn = (k2.collocation_grads_runs,
                              k2.collocation_grads_runs_bf16_plain)
    args = (params, x, V, w, gamma, scale, cots, bval, blap,
            "shifted_tanh", 3.0, 0.5, "abs_power")
    got, s = grads_fn(*args, compute_dtype=torch.bfloat16)
    want, ws = plain_fn(*args)
    for r in range(R or 1):
        pick = (lambda g: g) if R is None else (
            lambda g: tuple((a[r], b[r]) for a, b in g))
        _grads_close(pick(got), pick(want))
    np.testing.assert_allclose(s.cpu().numpy(), ws.cpu().numpy(), rtol=1e-4)
