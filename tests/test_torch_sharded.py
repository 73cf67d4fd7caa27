"""The port's mesh-sharded propagator (gpe_tpu_torch/dynamics/sharded.py) and
its tiled all-to-all (ops/collectives.all_to_all) on 2 and 4 gloo ranks on
the CPU, the cases of tests/test_dynamics_sharded.py: against the port's
single-device `evolve` at that test's bounds and against the JAX package's
`evolve_sharded` on the 8-virtual-device CPU mesh (tests/conftest.py); and,
in this process, `evolve` and `ground_state` after their refactor onto
`evolve_core` against a copy of the loop they had before it.

The ranks run in child processes (`experiments/mesh_check.run_cases`, one
spawn a rank count for the module) that import no JAX; JAX and the
single-device port run here. Inputs come from numpy.

Tolerances. Against the single-device `evolve`, the JAX test's: float64 ψ
atol 5e-13, the observables rtol 1e-11 and atol 1e-12 (the same operations;
the slabs' per-axis FFTs against `fftn` round differently; measured 3e-15).
Against JAX's `evolve_sharded`: tests/test_torch_dynamics.py's bounds for
the port's `evolve` against JAX's (pocketfft against torch's CPU FFT), float64
ψ atol 1e-12 and observables rtol 1e-10, float32 2e-5 and 2e-5. float32
against the single-device `evolve`: the JAX dry run's stage 6, ψ atol 1e-5
and μ rtol 1e-5. The all-to-all is a permutation: bit-equal.
"""
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from gpe_tpu.dynamics.sharded import evolve_sharded as jevolve_sharded  # noqa: E402
from gpe_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from gpe_tpu_torch.dynamics import split_step  # noqa: E402
from gpe_tpu_torch.dynamics import evolve, evolve_sharded, ground_state  # noqa: E402
from gpe_tpu_torch.experiments.mesh_check import run_cases  # noqa: E402
from gpe_tpu_torch.parallel.mesh import Mesh  # noqa: E402

OBS = ("norm", "energy", "mu", "center", "width_sq")
NPROCS = (2, 4)
CASES_2D = [("periodic", False), ("periodic", True), ("dirichlet", False)]
A2A_SHAPE = (8, 4, 12)


def _setup_2d(n=64, half=8.0, d=0.5):
    x = np.linspace(-half, half, n, endpoint=False)
    dx = x[1] - x[0]
    X, Y = np.meshgrid(x, x, indexing="ij")
    V = 0.5 * (X ** 2 + Y ** 2)
    psi0 = np.exp(-0.5 * ((X - d) ** 2 + Y ** 2)).astype(complex)
    psi0 = psi0 / np.sqrt(np.sum(np.abs(psi0) ** 2) * dx * dx)
    return x, dx, V, psi0


def _setup_3d(n=16, half=6.0):
    x = np.linspace(-half, half, n, endpoint=False)
    dx = x[1] - x[0]
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    V = 0.5 * (X ** 2 + Y ** 2 + Z ** 2)
    psi0 = np.exp(-0.5 * ((X - 0.4) ** 2 + Y ** 2 + Z ** 2)).astype(complex)
    psi0 = psi0 / np.sqrt(np.sum(np.abs(psi0) ** 2) * dx ** 3)
    return x, dx, V, psi0


def _inputs():
    """label -> (psi0, V, dx, kwargs): the JAX test's cases."""
    x, dx, V, psi0 = _setup_2d()
    out = {}
    for bc, imaginary in CASES_2D:
        out[f"{bc}_{imaginary}"] = (psi0, V, dx, dict(
            dt=2e-3, steps=150, gamma=20.0, kinetic=0.5, bc=bc, lb=float(x[0]),
            imaginary=imaginary, record_every=50))
    x3, dx3, V3, psi3 = _setup_3d()
    out["3d"] = (psi3, V3, dx3, dict(dt=2e-3, steps=70, gamma=10.0, lb=float(x3[0]),
                                     record_every=30))
    out["f32"] = (psi0.astype(np.complex64), V.astype(np.float32), dx, dict(
        dt=1e-3, steps=100, gamma=5.0, lb=float(x[0]), record_every=50))
    return out


INPUTS = _inputs()


@pytest.fixture(scope="module", params=NPROCS, ids=lambda p: f"{p}ranks")
def ranks(request):
    """Every case on `request.param` gloo ranks, once for the module: the
    inputs, the planted fault (the periodic real-time case with the tiles
    received in reverse rank order), that case on a group of the first two
    ranks (`ranks=2`) and the all-to-all."""
    cases = [(label, "sharded", dict(psi0=p0, V=V, dx=dx, **kw))
             for label, (p0, V, dx, kw) in INPUTS.items()]
    p0, V, dx, kw = INPUTS["periodic_False"]
    cases.append(("fault", "sharded", dict(psi0=p0, V=V, dx=dx, fault=True, **kw)))
    cases.append(("sub2", "sharded", dict(psi0=p0, V=V, dx=dx, ranks=2, **kw)))
    cases.append(("a2a", "all_to_all", dict(shape=A2A_SHAPE, seed=7)))
    return request.param, run_cases(cases, nprocs=request.param, backend="gloo",
                                    device="cpu")


@pytest.fixture(scope="module")
def single():
    """The port's single-device `evolve` of every case."""
    return {label: evolve(p0, V, dx, device="cpu", **kw)
            for label, (p0, V, dx, kw) in INPUTS.items()}


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's `evolve_sharded` of every case on its 8-device CPU
    mesh (float64 under enable_x64 where V is float64)."""
    out = {}
    for label, (p0, V, dx, kw) in INPUTS.items():
        with jax.enable_x64(V.dtype == np.float64):
            psi, obs = jevolve_sharded(p0, V, dx, mesh=jmake_mesh(8), **kw)
            out[label] = (np.asarray(psi), {k: np.asarray(v) for k, v in obs.items()})
    return out


def _obs(rank, label):
    return {k: rank[f"{label}/obs_{k}"] for k in OBS + ("t",)}


def _close(psi, obs, want_psi, want_obs, atol, rtol, obs_atol, keys=OBS):
    np.testing.assert_allclose(psi, want_psi, rtol=0, atol=atol)
    for k in keys:
        np.testing.assert_allclose(obs[k], np.asarray(want_obs[k]), rtol=rtol,
                                   atol=obs_atol(np.asarray(want_obs[k])), err_msg=k)
    np.testing.assert_allclose(obs["t"], np.asarray(want_obs["t"]))


def _replicated(ranks, label):
    """The observables and the gathered ψ are the same on every rank."""
    for r in ranks[1:]:
        for k in [f"{label}/psi"] + [f"{label}/obs_{o}" for o in OBS]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("bc,imaginary", CASES_2D)
def test_sharded_matches_single_device_2d(ranks, single, jax_sharded, bc, imaginary):
    nprocs, rs = ranks
    label = f"{bc}_{imaginary}"
    psi, obs = rs[0][f"{label}/psi"], _obs(rs[0], label)
    assert psi.dtype == np.complex128 and psi.shape == (64, 64)
    psi_1, obs_1 = single[label]
    _close(psi, obs, psi_1.numpy(), obs_1, 5e-13, 1e-11, lambda w: 1e-12)
    jpsi, jobs = jax_sharded[label]
    _close(psi, obs, jpsi, jobs, 1e-12, 1e-10, lambda w: 1e-10 * np.max(np.abs(w)))
    _replicated(rs, label)


def test_sharded_3d_and_remainder(ranks, single, jax_sharded):
    nprocs, rs = ranks
    psi, obs = rs[0]["3d/psi"], _obs(rs[0], "3d")
    assert len(obs["t"]) == 4 and abs(obs["t"][-1] - 0.140) < 1e-12
    psi_1, obs_1 = single["3d"]
    np.testing.assert_allclose(psi, psi_1.numpy(), rtol=0, atol=5e-13)
    np.testing.assert_allclose(obs["mu"], obs_1["mu"], rtol=1e-11)
    jpsi, jobs = jax_sharded["3d"]
    _close(psi, obs, jpsi, jobs, 1e-12, 1e-10, lambda w: 1e-10 * np.max(np.abs(w)))
    _replicated(rs, "3d")


def test_sharded_f32_matches_single_device_and_jax(ranks, single, jax_sharded):
    nprocs, rs = ranks
    psi, obs = rs[0]["f32/psi"], _obs(rs[0], "f32")
    assert psi.dtype == np.complex64
    assert np.max(np.abs(obs["norm"] - 1.0)) < 1e-4
    psi_1, obs_1 = single["f32"]
    np.testing.assert_allclose(psi, psi_1.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(obs["mu"], obs_1["mu"], rtol=1e-5)
    jpsi, jobs = jax_sharded["f32"]
    _close(psi, obs, jpsi, jobs, 2e-5, 2e-5, lambda w: 2e-5 * np.max(np.abs(w)))


def test_reversed_tile_transpose_fails_parity(ranks, single):
    """The planted fault (mesh_check.reversed_all_to_all) is caught by the
    parity bound it must fail."""
    nprocs, rs = ranks
    err = np.max(np.abs(rs[0]["fault/psi"] - single["periodic_False"][0].numpy()))
    assert err > 1e3 * 5e-13, err


def test_sharded_on_a_subgroup_of_the_ranks(ranks, single):
    """`ranks=2` runs the case on the first two ranks alone, as chip_smoke.py
    runs its 2D cases inside the four-rank spawn: the same bound against
    the single-device `evolve`; the other ranks return nothing."""
    nprocs, rs = ranks
    psi_1, obs_1 = single["periodic_False"]
    _close(rs[0]["sub2/psi"], _obs(rs[0], "sub2"), psi_1.numpy(), obs_1, 5e-13, 1e-11,
           lambda w: 1e-12)
    _replicated(rs[:2], "sub2")
    assert not any(k.startswith("sub2/") for r in rs[2:] for k in r)


def _tiled_transpose(blocks, split, concat):
    """numpy reference of `jax.lax.all_to_all(tiled=True)`: rank r receives
    tile r of every rank's block, concatenated in rank order."""
    P = len(blocks)
    return [np.concatenate([np.split(b, P, axis=split)[r] for b in blocks], axis=concat)
            for r in range(P)]


def test_all_to_all_is_the_tiled_transpose(ranks):
    nprocs, rs = ranks
    for name in ("c128", "f32"):
        blocks = []
        for r in range(nprocs):
            rng = np.random.default_rng(7 + r)
            z = rng.standard_normal(A2A_SHAPE) + 1j * rng.standard_normal(A2A_SHAPE)
            blocks.append(z if name == "c128" else z.real.astype(np.float32))
        for split in range(3):
            for concat in range(3):
                want = _tiled_transpose(blocks, split, concat)
                for r in range(nprocs):
                    got = rs[r][f"a2a/{name}_{split}{concat}"]
                    assert got.dtype == want[r].dtype
                    np.testing.assert_array_equal(got, want[r],
                                                  err_msg=f"{name} {split}->{concat} rank {r}")


def test_sharded_validates_the_grid():
    """The checks come before any collective: a mesh of 8 ranks, never
    joined, is enough to raise them."""
    mesh = Mesh(None, 0, 8, ("data",), torch.device("cpu"))
    x, dx, V, psi0 = _setup_2d()
    with pytest.raises(ValueError, match="divide"):
        evolve_sharded(psi0[:60], V[:60], dx, dt=1e-3, steps=10, gamma=0.0, mesh=mesh)
    with pytest.raises(ValueError, match="2-D"):
        evolve_sharded(psi0[0], V[0], dx, dt=1e-3, steps=10, gamma=0.0, mesh=mesh)


def _parent_spectral_ops(shape, dx, bc, real_dtype, device):
    """`split_step._spectral_ops` as it was before `_full_k2` was factored
    out of it."""
    ss = split_step
    dim = len(shape)
    vol = dx ** dim
    t = lambda a: torch.as_tensor(a, dtype=real_dtype, device=device)
    if bc == "periodic":
        ks = [t(2.0 * np.pi * np.fft.fftfreq(n, d=dx)) for n in shape]
        pw = vol / math.prod(shape)
        dims = tuple(range(dim))
        to_spec = lambda a: torch.fft.fftn(a, dim=dims)
        from_spec = lambda a: torch.fft.ifftn(a, dim=dims)
    elif bc == "dirichlet":
        ks = [t(np.pi * np.arange(1, n + 1) / ((n + 1) * dx)) for n in shape]
        pw = vol

        def to_spec(a):
            for ax in range(dim):
                a = ss._dst1_ortho(a, ax)
            return a
        from_spec = to_spec
    else:
        raise ValueError(f"unknown bc {bc!r}")
    k2 = sum(ss._axis_view(k, i, dim) ** 2 for i, k in enumerate(ks))

    def grad_sq_int(coef):
        return torch.sum(k2 * (coef.real ** 2 + coef.imag ** 2)) * pw

    return to_spec, from_spec, k2, grad_sq_int


def _parent_observables(a2, ke, V, xs, gamma, p, vol, inter):
    """`split_step.observables` as it was before it took `gsum`."""
    dim = a2.ndim
    norm = torch.sum(a2) * vol
    pe = torch.sum(V * a2) * vol
    inter = inter * vol
    energy = (ke + pe + (2.0 * gamma / (p + 1.0)) * inter) / norm
    mu = (ke + pe + gamma * inter) / norm
    centers, widths = [], []
    for ax in range(dim):
        xa = split_step._axis_view(xs[ax], ax, dim)
        c = torch.sum(xa * a2) * vol / norm
        centers.append(c)
        widths.append(torch.sum(xa * xa * a2) * vol / norm - c * c)
    return {"norm": norm, "energy": energy, "mu": mu,
            "center": torch.stack(centers), "width_sq": torch.stack(widths)}


def _parent_evolve(psi0, V, dx, dt, steps, gamma, kinetic=0.5, p=3.0, bc="periodic",
                   lb=0.0, imaginary=False, record_every=1, device=None):
    """`split_step.evolve` as it was before `evolve_core` was factored out of
    it, on the copies above of the two helpers that the refactor changed
    (the others are as they were), for the bit-equality tests below."""
    ss = split_step
    V = ss.as_real(V, device)
    shape, dim = tuple(V.shape), V.ndim
    cd = ss.complex_dtype(V.dtype)
    psi = torch.as_tensor(psi0, device=V.device).to(cd)
    vol = dx ** dim
    xs = [torch.as_tensor(x, dtype=V.dtype, device=V.device)
          for x in ss.axis_coords(shape, dx, lb, bc)]
    to_spec, from_spec, k2, grad_sq_int = _parent_spectral_ops(shape, dx, bc, V.dtype,
                                                               V.device)
    factor = -1.0 if imaginary else -1.0j
    kin_prop = torch.exp((factor * dt * kinetic) * k2.to(cd))
    half = 0.5 * dt * factor

    def step(psi):
        psi = psi * torch.exp(half * (V + gamma * ss.abs_pow(psi, p - 1.0)).to(cd))
        psi = from_spec(to_spec(psi) * kin_prop)
        psi = psi * torch.exp(half * (V + gamma * ss.abs_pow(psi, p - 1.0)).to(cd))
        if imaginary:
            psi = psi / torch.sqrt(torch.sum(psi.real ** 2 + psi.imag ** 2) * vol)
        return psi

    def observe(psi):
        a2 = psi.real ** 2 + psi.imag ** 2
        ke = kinetic * grad_sq_int(to_spec(psi))
        return _parent_observables(a2, ke, V, xs, gamma, p, vol,
                                   torch.sum(ss.abs_pow(psi, p + 1.0)))

    psi, obs = ss.run_recorded(step, psi, observe, int(steps), int(record_every))
    obs["t"] = ss.time_axis(int(steps), int(record_every), dt)
    return psi, obs


@pytest.mark.parametrize("grid", ["2d", "3d"])
@pytest.mark.parametrize("bc,imaginary", CASES_2D)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_evolve_after_the_refactor_is_bit_equal(grid, bc, imaginary, dtype):
    rng = np.random.default_rng(3)
    shape = (20, 12) if grid == "2d" else (8, 6, 10)
    V = (2.0 * rng.random(shape)).astype(dtype)
    psi0 = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    kw = dict(dt=1e-2, steps=7, gamma=5.0, bc=bc, imaginary=imaginary, record_every=3,
              lb=-1.0, device="cpu")
    psi, obs = evolve(psi0, V, 0.3, **kw)
    want_psi, want_obs = _parent_evolve(psi0, V, 0.3, **kw)
    assert torch.equal(psi, want_psi)
    for k in OBS + ("t",):
        np.testing.assert_array_equal(obs[k], want_obs[k], err_msg=k)


@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
def test_ground_state_after_the_refactor_is_bit_equal(monkeypatch, bc):
    x, dx, V, _ = _setup_2d(n=24)
    kw = dict(steps=600, chunk=200, tol=0.0, bc=bc, device="cpu")
    mu, psi = ground_state(V, dx, 3.0, **kw)
    monkeypatch.setattr(split_step, "evolve", _parent_evolve)
    want_mu, want_psi = split_step.ground_state(V, dx, 3.0, **kw)
    assert mu == want_mu and torch.equal(psi, want_psi)

