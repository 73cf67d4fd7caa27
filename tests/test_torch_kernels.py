"""Port parity: the plain versions of K1 (fused sums) and K2 (fused
gradient) against the JAX package's Pallas kernels in interpret mode and
against the XLA loss, plus the wrappers' CPU/CUDA contract.

Tolerances are those of tests/test_pallas.py and tests/test_pallas_grad.py
(f32 on both sides, other summation orders): rtol 2e-5 on loss values
(1e-5 on the gradient path's total and μ), normalised atol 2e-4 on grads.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpe_tpu.models import mlp as jmlp  # noqa: E402
from gpe_tpu.pallas.fused_grad import make_pallas_value_and_grad  # noqa: E402
from gpe_tpu.pallas.fused_residual import make_pallas_loss_eval  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu_torch.kernels import fused_grad as k2  # noqa: E402
from gpe_tpu_torch.kernels import fused_residual as k1  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402

CASES = {
    "2d_vanilla_tanh": (dict(dim=2, n_points=16, layers=(2, 32, 32, 32, 1),
                             potential="harmonic", potential_kwargs=(("a", 0.5),),
                             kinetic=0.5, lb=-6.0, ub=6.0, nonlinearity="abs_power",
                             use_perturbation=False, activation="tanh"),
                        10.0, 0.01, 128),
    "1d_shifted_tanh_power": (dict(dim=1, n_points=256, layers=(1, 32, 32, 32, 1),
                                   potential="harmonic", lb=-10.0, ub=10.0,
                                   nonlinearity="power", use_perturbation=False,
                                   activation="shifted_tanh"), 5.0, 1.0, 128),
    "1d_perturbation": (dict(dim=1, n_points=256, layers=(1, 32, 32, 32, 1),
                             potential="harmonic", lb=-10.0, ub=10.0,
                             nonlinearity="power", use_perturbation=True,
                             basis="hermite", activation="shifted_tanh"),
                        3.0, 0.01, 128),
    "2d_perturbation": (dict(dim=2, n_points=16, layers=(2, 32, 32, 32, 1),
                             potential="harmonic", potential_kwargs=(("a", 0.5),),
                             kinetic=0.5, lb=-8.0, ub=8.0, nonlinearity="abs_power",
                             use_perturbation=True, basis="hermite",
                             activation="shifted_tanh"), 5.0, 0.02, 128),
}


def _setup(name):
    kw, gamma, scale, tile = CASES[name]
    jspec, tspec = jprob.GPESpec(**kw), tprob.GPESpec(**kw)
    jparams = jmlp.init_mlp(jax.random.PRNGKey(0), jspec.layers)
    np_params = [(np.asarray(w), np.asarray(b)) for w, b in jparams]
    jbatch = jprob.make_batch(jspec, 0)
    tbatch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    return (jspec, tspec, jparams, params_from_numpy(np_params, device="cpu"), jbatch, tbatch,
            gamma, scale, tile)


def _phys(spec):
    return (spec.layers, spec.activation, spec.p, spec.kinetic, spec.nonlinearity)


def _grads_close(got, want, atol=2e-4):
    for li, ((gw, gb), (ww, wb)) in enumerate(zip(got, want)):
        for a, b, what in ((gw, ww, "W"), (gb, wb, "b")):
            b = np.asarray(b)
            s = np.max(np.abs(b)) + 1e-12
            np.testing.assert_allclose(np.asarray(a) / s, b / s, atol=atol,
                                       err_msg=f"{what} grad layer {li}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_k1_matches_pallas_and_xla(name):
    jspec, tspec, jparams, tparams, jbatch, tbatch, gamma, scale, tile = _setup(name)
    ev = make_pallas_loss_eval(*_phys(jspec), bc_weight=jspec.bc_weight,
                               norm_weight=jspec.norm_weight, tile=tile,
                               interpret=True)
    p_tot, p_aux = ev(jparams, jbatch, gamma, scale)
    x_tot, x_aux = jprob.make_loss_fn(jspec)(jparams, jbatch, gamma, scale)
    t_ev = k1.make_loss_eval(*_phys(tspec), bc_weight=tspec.bc_weight,
                             norm_weight=tspec.norm_weight)
    tot, aux = t_ev(tparams, tbatch, gamma, scale)
    for ref_tot, ref_aux in ((p_tot, p_aux), (x_tot, x_aux)):
        np.testing.assert_allclose(float(tot), float(ref_tot), rtol=2e-5)
        np.testing.assert_allclose(float(aux["mu"]), float(ref_aux["mu"]), rtol=2e-5)
        np.testing.assert_allclose(float(aux["pde"]), float(ref_aux["pde"]),
                                   rtol=2e-5, atol=1e-8)


def test_plain_k1_sums_match_pallas_collocation_sums():
    jspec, tspec, jparams, tparams, jbatch, tbatch, gamma, scale, tile = \
        _setup("2d_perturbation")
    ev = make_pallas_loss_eval(*_phys(jspec), tile=tile, interpret=True)
    want = ev.collocation_sums(jparams, jbatch["x"], jbatch["V"], jbatch["w"],
                               gamma, scale, jbatch["base_val"], jbatch["base_lap"])
    got = k1.collocation_sums(tparams, tbatch["x"], tbatch["V"], tbatch["w"],
                              gamma, scale, tbatch["base_val"], tbatch["base_lap"],
                              tspec.activation, tspec.p, tspec.kinetic,
                              tspec.nonlinearity)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.stack(want)), rtol=2e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_exact_vag_matches_pallas_and_autodiff(name):
    jspec, tspec, jparams, tparams, jbatch, tbatch, gamma, scale, tile = _setup(name)
    g, s = jnp.float32(gamma), jnp.float32(scale)
    (x_tot, x_aux), x_grads = jax.value_and_grad(
        jprob.make_loss_fn(jspec), has_aux=True)(jparams, jbatch, g, s)
    pvag = make_pallas_value_and_grad(*_phys(jspec), bc_weight=jspec.bc_weight,
                                      norm_weight=jspec.norm_weight, tile=tile,
                                      sum_tile=tile, interpret=True)
    (p_tot, p_aux), p_grads = pvag(jparams, jbatch, g, s)
    tvag = k2.make_value_and_grad(*_phys(tspec), bc_weight=tspec.bc_weight,
                                  norm_weight=tspec.norm_weight)
    (tot, aux), grads = tvag(tparams, tbatch, gamma, scale)
    for ref_tot, ref_aux, ref_grads in ((x_tot, x_aux, x_grads),
                                        (p_tot, p_aux, p_grads)):
        np.testing.assert_allclose(float(tot), float(ref_tot), rtol=1e-5)
        np.testing.assert_allclose(float(aux["mu"]), float(ref_aux["mu"]), rtol=1e-5)
        _grads_close(grads, ref_grads)


@pytest.mark.parametrize("name", ["1d_perturbation", "2d_perturbation"])
def test_plain_relaxed_vag_matches_pallas_over_steps(name):
    """relaxed + fresh_values + extrapolate, threaded over 4 steps from the
    same param sequence on both sides (the updates come from JAX's grads)."""
    jspec, tspec, jparams, tparams, jbatch, tbatch, gamma, scale, tile = _setup(name)
    g, s = jnp.float32(gamma), jnp.float32(scale)
    modes = dict(delayed=True, fresh_values=True, extrapolate=True)
    pvag = make_pallas_value_and_grad(*_phys(jspec), bc_weight=jspec.bc_weight,
                                      norm_weight=jspec.norm_weight, tile=tile,
                                      sum_tile=tile, interpret=True, **modes)
    tvag = k2.make_value_and_grad(*_phys(tspec), bc_weight=tspec.bc_weight,
                                  norm_weight=tspec.norm_weight, **modes)
    jst = pvag.init_state(jparams, jbatch, g, s)
    tst = tvag.init_state(tparams, tbatch, gamma, scale)
    for step in range(4):
        (p_tot, p_aux), p_grads, jst = pvag(jparams, jbatch, g, s, jst)
        (tot, aux), grads, tst = tvag(tparams, tbatch, gamma, scale, tst)
        np.testing.assert_allclose(float(tot), float(p_tot), rtol=1e-5)
        np.testing.assert_allclose(float(aux["mu"]), float(p_aux["mu"]), rtol=1e-5)
        _grads_close(grads, p_grads)
        np.testing.assert_allclose(tst[0].numpy(), np.asarray(jst[0]), rtol=2e-5)
        assert tst[2] == int(jst[2]) == step + 1
        jparams = jax.tree.map(lambda p, d: p - 3e-3 * d, jparams, p_grads)
        tparams = params_from_numpy([(np.asarray(w), np.asarray(b))
                                     for w, b in jparams], device="cpu")


def test_relaxed_refresh_step_is_exact():
    """refresh_every=1: every step after the first runs K1 and equals the
    exact gradient of the current params."""
    _, tspec, _, tparams, _, tbatch, gamma, scale, _ = _setup("1d_perturbation")
    mk = lambda **kw: k2.make_value_and_grad(*_phys(tspec), **kw)
    exact, refresh = mk(), mk(delayed=True, refresh_every=1)
    st = refresh.init_state(tparams, tbatch, gamma, scale)
    _, g0, st = refresh(tparams, tbatch, gamma, scale, st)
    p1 = tuple((w - 1e-2 * gw, b - 1e-2 * gb) for (w, b), (gw, gb) in zip(tparams, g0))
    _, g_ref = exact(p1, tbatch, gamma, scale)
    _, g1, _ = refresh(p1, tbatch, gamma, scale, st)
    _grads_close(g1, g_ref, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    _, tspec, _, tparams, _, tbatch, gamma, scale, _ = _setup("2d_perturbation")
    k1.collocation_sums.launches = 0
    k2.collocation_grads.launches = 0
    args = (tparams, tbatch["x"], tbatch["V"], tbatch["w"], gamma, scale)
    base = (tbatch["base_val"], tbatch["base_lap"])
    phys = (tspec.activation, tspec.p, tspec.kinetic, tspec.nonlinearity)
    got = k1.collocation_sums(*args, *base, *phys)
    want = k1.collocation_sums_plain(*args, *base, *phys)
    assert torch.equal(got, want)
    cots = torch.tensor([1e-3, -2e-3, 1e-3, 0.5])
    grads, sums = k2.collocation_grads(*args, cots, *base, *phys)
    pgrads, psums = k2.collocation_grads_plain(*args, cots, *base, *phys)
    assert torch.equal(sums, psums)
    for a, b in zip(grads, pgrads):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert k1.collocation_sums.launches == 0
    assert k2.collocation_grads.launches == 0


def test_fused_gate_is_none_on_cpu_and_checks_the_net(monkeypatch):
    monkeypatch.delenv("GPE_TPU_TORCH_NO_FUSED", raising=False)
    spec = tprob.GPESpec(**CASES["2d_perturbation"][0])
    assert tprob.make_fused_value_and_grad(spec, device="cpu") is None
    assert k2.kernel_supports(spec.layers, spec.activation)
    assert not k2.kernel_supports((2, 256, 1), "tanh")
    assert not k2.kernel_supports((2, 64, 1), "gelu")
    assert not k2.kernel_supports((4, 64, 1), "tanh")


def test_relaxed_default_resolution(monkeypatch):
    monkeypatch.delenv("GPE_TPU_TORCH_NO_RELAXED", raising=False)
    assert tprob._resolve_relaxed(None, None, None) == (True, True, True)
    assert tprob._resolve_relaxed(False, None, None) == (False, False, False)
    assert tprob._resolve_relaxed(True, False, None) == (True, False, False)
    monkeypatch.setenv("GPE_TPU_TORCH_NO_RELAXED", "1")
    assert tprob._resolve_relaxed(None, None, None) == (False, False, False)


RELAXED_ENV = ("NO_RELAXED", "RELAXED_FUSED", "RELAXED_EXTRAP", "RELAXED_FRESH",
               "RELAXED_REFRESH", "RELAXED_EXACT_UNTIL", "NO_FUSED")


@pytest.mark.parametrize("env", [
    {}, {"NO_RELAXED": "1"}, {"RELAXED_FUSED": "1"},
    {"RELAXED_FUSED": "1", "RELAXED_EXTRAP": "1"},
    {"RELAXED_FUSED": "1", "RELAXED_FRESH": "1", "RELAXED_REFRESH": "5"},
    {"NO_RELAXED": "1", "RELAXED_EXTRAP": "1", "RELAXED_EXACT_UNTIL": "30"},
    {"RELAXED_FRESH": "1", "RELAXED_REFRESH": "3", "RELAXED_EXACT_UNTIL": "10"},
    {"NO_RELAXED": "1", "RELAXED_FUSED": "1"}])
def test_relaxed_env_switches_resolve_as_in_jax(env, monkeypatch):
    """Each GPE_TPU_TORCH_<switch> setting resolves as the JAX package
    resolves its GPE_TPU_<switch> twin: the relaxed triple under every
    explicit-kwarg pattern (explicit kwargs win), and the options that the
    single-run and the packed factory pass on to the gradient builder."""
    import gpe_tpu.pallas as jpallas
    from gpe_tpu_torch.kernels import fused_grad as tfg

    for name in RELAXED_ENV:
        for prefix in ("GPE_TPU_", "GPE_TPU_TORCH_"):
            monkeypatch.delenv(prefix + name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv("GPE_TPU_" + name, value)
        monkeypatch.setenv("GPE_TPU_TORCH_" + name, value)
    for kw in [(None, None, None), (True, None, None), (False, None, None),
               (None, False, None), (None, None, True), (True, True, False)]:
        want = tuple(bool(v) for v in jprob._resolve_relaxed(*kw))
        assert tprob._resolve_relaxed(*kw) == want, kw

    seen = {}
    keys = ("delayed", "refresh_every", "extrapolate", "exact_until", "fresh_values")

    def capture(side):
        def builder(*args, **kw):
            seen[side] = tuple(bool(kw[k]) if k in ("delayed", "extrapolate",
                                                    "fresh_values") else int(kw[k])
                               for k in keys)
            return object()
        return builder

    monkeypatch.setattr(jpallas, "make_pallas_value_and_grad", capture("jax"))
    monkeypatch.setattr(jpallas, "pallas_supported", lambda: True)
    monkeypatch.setattr(tfg, "make_value_and_grad", capture("torch"))
    monkeypatch.setattr(tprob, "resolve_device", lambda device=None: torch.device("cuda"))
    single = dict(dim=2, n_points=128, layers=(2, 32, 32, 1), lb=-6.0, ub=6.0,
                  potential_kwargs=(("a", 0.5),), kinetic=0.5)
    packed = dict(n_points=4000, lb=-10.0, ub=10.0, p=3.0, nonlinearity="power",
                  layers=(1, 64, 64, 1), activation="shifted_tanh")
    for explicit in ({}, {"refresh_every": 7, "extrapolate": False}):
        for mod, more in ((jprob, {"interpret": True}), (tprob, {})):
            side = "jax" if mod is jprob else "torch"
            assert mod.make_fused_value_and_grad(mod.GPESpec(**single),
                                                 **explicit) is not None
            fused = seen.pop(side)
            assert mod.make_packed_value_and_grad(mod.GPESpec(**packed), 2, **more,
                                                  **explicit) is not None
            seen[side] = (fused, seen.pop(side))
        assert seen["torch"] == seen["jax"], (explicit, seen)


def test_kernel_input_checks_reject_malformed_input():
    from gpe_tpu_torch.kernels._common import check_inputs
    _, _, _, tparams, _, tbatch, _, _, _ = _setup("2d_perturbation")
    x, V, w = tbatch["x"], tbatch["V"], tbatch["w"]
    assert check_inputs(tparams, x, V, w, None, None) == (256, [2, 32, 32, 32, 1])
    bad_chain = (tparams[0], (tparams[1][0][:16], tparams[1][1]), *tparams[2:])
    for args in ((tparams, x.double(), V, w, None, None),
                 (tparams, x, V[:-1], w, None, None),
                 (tparams, x, V, w, tbatch["base_val"][:5], None),
                 (tparams, x[:, :1].contiguous(), V, w, None, None),
                 (tparams, x.t().contiguous().t(), V, w, None, None),
                 (bad_chain, x, V, w, None, None)):
        with pytest.raises(ValueError):
            check_inputs(*args)


@pytest.mark.parametrize("runs", [None, 6])
@pytest.mark.parametrize("width", [100, 128])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_padded_weights_plain_layout(d, width, runs):
    """K2's padded-weight layout (plain version of the layout kernel): per run,
    each hidden GEMM layer's W_l as (K, 128) then W_lᵀ as (N, 128), zero past
    the widths — held to the weights of pack_params/unpack_flat and to the
    JAX package's _pad_params (128 x 128 for these widths)."""
    from gpe_tpu.pallas.fused_residual import _pad_params
    from gpe_tpu_torch.kernels._common import pack_params, unpack_flat

    layers = (d, width, width, width, 1)
    rng = np.random.default_rng(d * width)
    lead = () if runs is None else (runs,)
    np_params = [(rng.normal(size=lead + (k, m)), rng.normal(size=lead + (m,)))
                 for k, m in zip(layers[:-1], layers[1:])]
    params = params_from_numpy(np_params, device="cpu")
    got = k2.padded_weights(params, runs)
    assert got.shape == lead + (k2.padded_floats(layers),)
    assert got.shape[-1] == 2 * 2 * width * 128
    flat = unpack_flat(pack_params(params, runs), layers)
    for r in range(runs or 1):
        row = got[r] if runs else got
        jax_padded = _pad_params([(w[r] if runs else w, b[r] if runs else b)
                                  for w, b in np_params])
        off = 0
        for li in (1, 2):
            W = flat[li][0][r] if runs else flat[li][0]
            K, N = W.shape
            fwd = row[off:off + K * 128].reshape(K, 128)
            off += K * 128
            bwd = row[off:off + N * 128].reshape(N, 128)
            off += N * 128
            assert torch.equal(fwd[:, :N], W) and not fwd[:, N:].any()
            assert torch.equal(bwd[:, :K], W.t()) and not bwd[:, K:].any()
            jw = np.asarray(jax_padded[li][0])
            np.testing.assert_array_equal(fwd.numpy(), jw[:K])
            np.testing.assert_array_equal(bwd.numpy(), jw.T[:N])
        assert off == row.shape[0]


@pytest.mark.parametrize("variant", ["as_is", "ffma_reverse", "tf32x1", "cvt_rna",
                                     "tile_guards", "fragment_epilogue", "first_form",
                                     "as_is+clocks", "fragment_epilogue+clocks"])
def test_k2_variant_patches_apply_to_the_kernel_source(variant, tmp_path):
    """experiments/k2_variants.py's patches of csrc/fused_grad.cu still find
    their anchor text, each the expected number of times, and change the
    source (the build and the timing need the card)."""
    from gpe_tpu_torch.experiments import k2_variants as kv
    from gpe_tpu_torch.kernels import _build

    name, _, clocked = variant.partition("+")
    patches = [x for p in kv.VARIANTS[name][0] for x in kv.PATCHES[p]]
    patches += kv.CLOCK_PATCH if clocked else []
    kv.write_variant(variant, patches, tmp_path)
    files = ("fused_grad.cu", "common.cuh")      # K2's source and its shared GEMMs
    src = [(_build.CSRC / f).read_text() for f in files]
    out = [(tmp_path / variant / f).read_text() for f in files]
    assert (out == src) == (not patches)
    out = out[0]
    if clocked:
        assert "gpe_k2_clocks" in out


@pytest.mark.parametrize("variant", ["as_is", "ffma_forward", "bf16x2", "mma_chain",
                                     "as_is+clocks", "parent+clocks"])
def test_k2_bf16_variant_patches_apply_to_the_kernel_source(variant, tmp_path):
    """experiments/k2_variants.py's bf16 variants (--bf16) still find their
    anchor text in csrc/fused_grad.cu and csrc/common.cuh, each the expected
    number of times, and change only the files they name; the clock marks
    ("parent+clocks" alone) are text that a parent before the three-term
    GEMM has too."""
    from gpe_tpu_torch.experiments import k2_variants as kv
    from gpe_tpu_torch.kernels import _build

    patches = kv.patches_of(variant, bf16=True)
    kv.write_variant(variant, patches, tmp_path)
    files = ("fused_grad.cu", "common.cuh")
    src = [(_build.CSRC / f).read_text() for f in files]
    out = [(tmp_path / variant / f).read_text() for f in files]
    assert (out == src) == (not patches)
    touched = {f for f, *_ in patches}
    assert all((o != s) == (f in touched) for f, o, s in zip(files, out, src))
    if variant == "ffma_forward":      # forward_tile's and forward_deep's branches off
        assert all("if constexpr (false)" in o for o in out)
    if variant.endswith("+clocks"):
        assert "gpe_k2_clocks" in out[0] and "CLK(4);" in out[0]


@pytest.mark.parametrize("variant", ["as_is", "ffma_forward", "tf32x1", "one_block_per_sm",
                                     "half_warps", "as_is+clocks"])
def test_k1_variant_patches_apply_to_the_kernel_source(variant, tmp_path):
    """experiments/k1_variants.py's patches of csrc/fused_residual.cu and
    csrc/common.cuh still find their anchor text, each the expected number
    of times, and change the source (the build and the timing need the
    card). Its ablations of the kernel before the redesign patch that
    tree's sources, not these."""
    from gpe_tpu_torch.experiments import k1_variants as kv
    from gpe_tpu_torch.kernels import _build

    assert variant.partition("+")[0] in kv.CURRENT
    patches = kv.patches_of(variant)
    kv.write_variant(variant, patches, tmp_path)
    files = ("fused_residual.cu", "common.cuh")
    src = [(_build.CSRC / f).read_text() for f in files]
    out = [(tmp_path / variant / f).read_text() for f in files]
    assert (out == src) == (not patches)
    if variant.endswith("+clocks"):
        assert "gpe_k1_clocks" in out[0] and "CLK(" in out[1]


@pytest.mark.parametrize("variant", ["as_is", "ffma", "rounded_staging", "split_tail",
                                     "no_operand_loads",
                                     "as_is+clocks", "parent+clocks"])
def test_bf16_variant_patches_apply_to_the_kernel_source(variant, tmp_path):
    """experiments/bf16_variants.py's patches of csrc/fused_residual.cu,
    csrc/rowcat_eval.cu and csrc/common.cuh still find their anchor text,
    each the expected number of times, and change the source (the build and
    the timing need the card). The clock marks ("parent+clocks" alone) must
    apply to a parent checkout's sources too; their anchors are text this
    change left as it was."""
    from gpe_tpu_torch.experiments import bf16_variants as bv
    from gpe_tpu_torch.kernels import _build

    patches = bv.patches_of(variant)
    bv.write_variant(variant, patches, tmp_path)
    files = ("fused_residual.cu", "rowcat_eval.cu", "common.cuh")
    src = [(_build.CSRC / f).read_text() for f in files]
    out = [(tmp_path / variant / f).read_text() for f in files]
    assert (out == src) == (not patches)
    touched = {f for f, *_ in patches}
    assert all((o != s) == (f in touched) for f, o, s in zip(files, out, src))
    if variant.endswith("+clocks"):
        assert "gpe_k1_clocks" in out[0] and "gpe_k4_clocks" in out[1] and "CLK(" in out[2]


@pytest.mark.parametrize("variant", ["as_is", "ffma", "tf32x1", "stride4",
                                     "as_is+clocks", "parent+clocks"])
def test_k4_variant_patches_apply_to_the_kernel_source(variant, tmp_path):
    """experiments/k4_variants.py's patches of csrc/rowcat_eval.cu and
    csrc/common.cuh still find their anchor text, each the expected number
    of times, and change the source (the build and the timing need the
    card). The clock marks ("parent+clocks" alone) must apply to a parent
    checkout's sources too; their anchors are text the GEMM's redesign left
    as it was."""
    from gpe_tpu_torch.experiments import k4_variants as kv
    from gpe_tpu_torch.kernels import _build

    patches = kv.patches_of(variant)
    kv.write_variant(variant, patches, tmp_path)
    files = ("rowcat_eval.cu", "common.cuh")
    src = [(_build.CSRC / f).read_text() for f in files]
    out = [(tmp_path / variant / f).read_text() for f in files]
    assert (out == src) == (not patches)
    touched = {f for f, *_ in patches}
    assert all((o != s) == (f in touched) for f, o, s in zip(files, out, src))
    if variant.endswith("+clocks"):
        assert "gpe_k4_clocks" in out[0] and "CLK(" in out[0] and "g_clk" in out[1]
    if variant == "ffma":
        assert "fmaf(av[e], bv[f], acc[e][f])" in out[0]
