"""The port's mesh (gpe_tpu_torch/parallel/mesh.py) on two gloo ranks on the
CPU: the sharded loss and step, the ensemble meshes (`make_ensemble_step`,
`fit_ensemble(mesh=)` on both routes, `fit_ensemble_packed(mesh=)`),
`train_plpinn(mesh=)`, the compare functions with `mesh=` and the runner's
`plpinn_sharded_dp`, against JAX's
and the port's unsharded results (the contracts of tests/test_parallel.py
and test_multihost.py); and, in this process, `initialize_multihost`,
`make_mesh` and `fit`'s psum-aware gate.

The ranks run in child processes (`experiments/mesh_check.run_cases`, one
spawn for the module) that import no JAX; JAX and the unsharded port run
here. Inputs come from numpy with a seed. Tolerances: the sharded loss
against JAX's rtol 1e-5, the step's params rtol 1e-4 (test_parallel.py's);
the ensembles rtol 1e-5 against the unsharded ensemble, as JAX holds its
ensemble step; `train_plpinn` μ rtol 5e-4 (test_parallel.py:227-242).
Replicated results must be bit-equal across the ranks.
"""
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from gpe_tpu.parallel import mesh as jmesh  # noqa: E402
from gpe_tpu.train import problem as jprob  # noqa: E402
from gpe_tpu.train.optimizers import make_optimizer as jmake_optimizer  # noqa: E402
from gpe_tpu_torch.experiments.mesh_check import flat, run_cases  # noqa: E402
from gpe_tpu_torch.kernels import fused_grad as k2  # noqa: E402
from gpe_tpu_torch.models.mlp import params_from_numpy  # noqa: E402
from gpe_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from gpe_tpu_torch.train import compare as tcompare  # noqa: E402
from gpe_tpu_torch.train import loop as tloop  # noqa: E402
from gpe_tpu_torch.train import packed as tpacked  # noqa: E402
from gpe_tpu_torch.train import plpinn as tpl  # noqa: E402
from gpe_tpu_torch.train import problem as tprob  # noqa: E402
from gpe_tpu_torch.train.optimizers import make_optimizer  # noqa: E402

LOSS = dict(n_points=512, dim=1, layers=(1, 16, 16, 1))          # test_parallel.py
ENS = dict(lb=-6.0, ub=6.0, n_points=256, layers=(1, 8, 8, 1), potential="harmonic",
           basis="hermite", nonlinearity="abs_power", use_perturbation=False)
PACKED = dict(ENS, layers=(1, 64, 64, 1))      # M = 2 runs a unit: 2 units of 4 runs
PLPINN = dict(lb=-8.0, ub=8.0, n_points=512, layers=(1, 16, 16, 1), activation="tanh",
              potential="harmonic", basis="hermite", nonlinearity="power",
              use_perturbation=True)
PLPINN_KW = dict(gamma_values=[0.0, 1.0], modes=(0,), epochs=300, tol=1e-6,
                 patience=10 ** 9, pretrain_epochs=300, check_every=150, seed=3)
COMPARE = dict(n_points=128, layers=(1, 12, 12, 1))            # test_torch_compare.py
COMPARE_KW = dict(epochs=60, tol=0.0, patience=10 ** 9, check_every=30,
                  pretrain_epochs=30)
R = 8
SCALES = np.linspace(0.5, 1.2, R).astype(np.float32)
ENS_FIT = dict(epochs=120, check_every=60)


def _np_params(layers, seed, runs=None):
    rng = np.random.default_rng(seed)
    lead = () if runs is None else (runs,)
    return [(rng.uniform(-1.0, 1.0, lead + (k, m)).astype(np.float32)
             * np.float32(np.sqrt(6.0 / (k + m))), np.full(lead + (m,), 0.01, np.float32))
            for k, m in zip(layers[:-1], layers[1:])]


def _j(params):
    return [(jnp.asarray(W), jnp.asarray(b)) for W, b in params]


def _cases(out):
    spec = tprob.GPESpec(**ENS)
    return [
        ("steps", "steps", dict(spec=tprob.GPESpec(**LOSS),
                                params=_np_params(LOSS["layers"], 0), gamma=0.5,
                                scale=0.01)),
        ("ens_step", "ensemble_step", dict(spec=spec, params_b=_np_params(ENS["layers"], 1, R),
                                           gamma=1.0, scales=SCALES)),
        ("ens", "ensemble", dict(spec=spec, params_b=_np_params(ENS["layers"], 2, R),
                                 gamma=1.0, scales=1.0, fused=False, **ENS_FIT)),
        ("ens_fused", "ensemble", dict(spec=spec, params_b=_np_params(ENS["layers"], 3, R),
                                       gamma=1.0, scales=SCALES, fused=True, **ENS_FIT)),
        ("packed", "packed", dict(spec=tprob.GPESpec(**PACKED),
                                  params_b=_np_params(PACKED["layers"], 4, 4), gamma=1.0,
                                  scales=1.0, epochs=40, check_every=20)),
        ("plpinn", "plpinn", dict(spec=tprob.GPESpec(**PLPINN), device="cpu", **PLPINN_KW)),
        ("compare", "compare", dict(spec=tprob.GPESpec(**COMPARE), gamma=1.0, n_runs=2,
                                    device="cpu", **COMPARE_KW)),
        ("runner", "runner", dict(argv=["plpinn_sharded_dp", "--cpu", "--train",
                                        "--epochs", "5", "--pretrain", "5", "--gammas",
                                        "0", "1", "--out", str(out)])),
    ]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_runner")


@pytest.fixture(scope="module")
def ranks(run_dir):
    """Every case on two gloo ranks, once for the module."""
    return run_cases(_cases(run_dir), nprocs=2, backend="gloo", device="cpu")


def _bit_equal(ranks, label, keys):
    for k in keys:
        np.testing.assert_array_equal(ranks[0][f"{label}/{k}"], ranks[1][f"{label}/{k}"],
                                      err_msg=k)


def test_parallel_loss_matches_jax_single_device(ranks):
    jspec = jprob.GPESpec(**LOSS)
    total, aux = jprob.make_loss_fn(jspec)(_j(_np_params(LOSS["layers"], 0)),
                                           jprob.make_batch(jspec, 0), jnp.float32(0.5),
                                           jnp.float32(0.01))
    np.testing.assert_allclose(ranks[0]["steps/loss_total"], float(total), rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["steps/loss_mu"], float(aux["mu"]), rtol=1e-5)
    _bit_equal(ranks, "steps", ("loss_total", "loss_mu"))


def test_parallel_step_matches_jax_single_device(ranks):
    """One step of Adam (clip 1.0) on the sharded loss against JAX's step
    on the whole batch: the averaged gradients are the global gradient."""
    jspec = jprob.GPESpec(**LOSS)
    loss_fn = jprob.make_loss_fn(jspec)
    opt = jmake_optimizer("adam", 1e-3, clip_norm=1.0)
    p = _j(_np_params(LOSS["layers"], 0))
    (total, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        p, jprob.make_batch(jspec, 0), jnp.float32(0.5), jnp.float32(0.01))
    updates, _ = opt.update(grads, opt.init(p), p)
    want = optax.apply_updates(p, updates)
    np.testing.assert_allclose(ranks[0]["steps/step_total"], float(total), rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["steps/step_params"],
                               np.concatenate([np.asarray(a).ravel() for W, b in want
                                               for a in (W, b)]), rtol=1e-4, atol=1e-7)
    _bit_equal(ranks, "steps", ("step_total", "step_params"))


def test_ensemble_step_matches_jax_vmap(ranks):
    """Eight runs, four a rank, one Adam step each against JAX's vmapped
    step on one device."""
    jspec = jprob.GPESpec(**ENS)
    loss_fn = jprob.make_loss_fn(jspec)
    batch = jprob.make_batch(jspec, 0)
    opt = optax.adam(1e-3)
    pb = jax.tree.map(jnp.asarray, tuple(tuple(x) for x in _np_params(ENS["layers"], 1, R)))

    def one(p, s, sc):
        (t, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p, batch, jnp.float32(1.0), sc)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), t, aux["mu"]

    ref_p, ref_t, ref_mu = jax.vmap(one)(pb, jax.vmap(opt.init)(pb), jnp.asarray(SCALES))
    r = ranks[0]
    np.testing.assert_allclose(r["ens_step/total"], np.asarray(ref_t), rtol=1e-5)
    np.testing.assert_allclose(r["ens_step/mu"], np.asarray(ref_mu), rtol=1e-5)
    np.testing.assert_allclose(r["ens_step/params"],
                               np.concatenate([np.asarray(a).ravel() for W, b in ref_p
                                               for a in (W, b)]), rtol=1e-5, atol=1e-7)
    _bit_equal(ranks, "ens_step", ("total", "mu", "params"))


def _ensemble(seed, scales, vag):
    spec = tprob.GPESpec(**ENS)
    return tloop.fit_ensemble(
        tprob.make_loss_fn(spec), make_optimizer("adam", 1e-3, clip_norm=1.0),
        params_from_numpy(_np_params(ENS["layers"], seed, R), device="cpu"),
        tprob.make_batch(spec, 0, device="cpu"), 1.0, scales, tol=0.0,
        patience=10 ** 9, value_and_grad_fn=vag, **ENS_FIT)


def _assert_ensemble(ranks, label, ref):
    r = ranks[0]
    np.testing.assert_array_equal(r[f"{label}/epochs_run"], ref.epochs_run)
    for k in ("loss_history", "mu_history", "mu", "best_loss", "mu_best"):
        np.testing.assert_allclose(r[f"{label}/{k}"], getattr(ref, k), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(r[f"{label}/params"], flat(ref.params), rtol=1e-5, atol=1e-7)
    _bit_equal(ranks, label, ("loss_history", "mu_history", "mu", "best_loss", "mu_best",
                              "epochs_run", "params"))


def test_fit_ensemble_mesh_plain_route_matches_unsharded(ranks):
    """torch.func route, four runs a rank, gathered on every rank."""
    _assert_ensemble(ranks, "ens", _ensemble(2, 1.0, None))


def test_fit_ensemble_mesh_fused_route_matches_unsharded(ranks):
    """The fused route (the run-mode twin of the exact fused vag, its plain
    versions on the CPU) with a scale per run."""
    spec = tprob.GPESpec(**ENS)
    vag = k2.make_value_and_grad(spec.layers, spec.activation, spec.p, spec.kinetic,
                                 spec.nonlinearity, bc_weight=spec.bc_weight,
                                 norm_weight=spec.norm_weight)
    _assert_ensemble(ranks, "ens_fused", _ensemble(3, SCALES, vag))


def test_fit_ensemble_packed_mesh_two_units_over_two_ranks(ranks):
    """Width 64 packs M = 2 runs a unit: four runs are two units, one a
    rank, against the unsharded packed fit."""
    spec = tprob.GPESpec(**PACKED)
    ref = tpacked.fit_ensemble_packed(
        spec, params_from_numpy(_np_params(PACKED["layers"], 4, 4), device="cpu"),
        tprob.make_batch(spec, 0, device="cpu"), 1.0, 1.0, epochs=40, tol=0.0,
        patience=10 ** 9, check_every=20, lr_mode="cosine")
    _assert_ensemble(ranks, "packed", ref)


def test_fit_ensemble_packed_mesh_refuses_units_that_do_not_divide():
    mesh = tmesh.Mesh(None, 0, 2, ("ens",), torch.device("cpu"))
    spec = tprob.GPESpec(**PACKED)
    with pytest.raises(ValueError, match="packed unit count 1"):
        tpacked.fit_ensemble_packed(
            spec, params_from_numpy(_np_params(PACKED["layers"], 4, 2), device="cpu"),
            tprob.make_batch(spec, 0, device="cpu"), 1.0, 1.0, epochs=2, mesh=mesh)


def test_train_plpinn_mesh_matches_single_process(ranks):
    """The whole PL-PINN trainer (pretraining, q-scale, warm start, early
    stop) over a 2-rung ramp with the fits sharded, against one process."""
    ref = tpl.train_plpinn(tprob.GPESpec(**PLPINN), device="cpu", **PLPINN_KW)
    got = ranks[0]["plpinn/mu_table"]
    np.testing.assert_array_equal(got[:, 0], [g for g, _ in ref.mu_table[0]])
    np.testing.assert_allclose(got[:, 1], [m for _, m in ref.mu_table[0]], rtol=5e-4)
    _bit_equal(ranks, "plpinn", ("mu_table", "epochs"))


def test_compare_functions_with_a_mesh_match_one_process(ranks):
    """train_single_model(mesh=) shards the points of its one fit (no fused
    gradient), train_multiple_runs(mesh=) its two seeds, one a rank:
    against the same calls in one process."""
    spec = tprob.GPESpec(**COMPARE)
    one = tcompare.train_single_model(spec, 1.0, device="cpu", **COMPARE_KW)
    many = tcompare.train_multiple_runs(spec, 1.0, n_runs=2, device="cpu", **COMPARE_KW)
    r = ranks[0]
    np.testing.assert_allclose(r["compare/single_loss_history"], one.loss_history,
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(r["compare/single_mu"], one.mu, rtol=1e-5)
    np.testing.assert_allclose(r["compare/multi_mu_runs"], many["mu_runs"], rtol=1e-5)
    np.testing.assert_array_equal(r["compare/multi_epochs"], many["epochs_run"])
    _bit_equal(ranks, "compare", ("single_mu", "single_loss_history", "multi_mu_runs"))


def test_runner_plpinn_sharded_dp_on_two_ranks(ranks, run_dir):
    """run.py's plpinn branch of `plpinn_sharded_dp` at tiny depth on both
    ranks: rc 0 on each, one record written by rank 0 with mesh_devices 2
    and a finite μ for both rungs."""
    assert [int(r["runner/rc"]) for r in ranks] == [0, 0]
    rec = json.loads((run_dir / "plpinn_sharded_dp" / "summary.json").read_text())
    assert rec["experiment"] == "plpinn_sharded_dp" and rec["mesh_devices"] == 2
    assert np.isfinite(rec["mu_table_tail"]["0"][1])
    assert "launches" not in rec           # a CPU run counts no launch


def test_batch_pspecs_follow_jax():
    """The structural rule: every entry as long as the collocation axis is
    sharded, the boundary points and the rest replicated, as in JAX."""
    for kw in (PLPINN, dict(ENS, symmetry="even")):
        jb = jprob.make_batch(jprob.GPESpec(**kw), 0)
        tb = tprob.make_batch(tprob.GPESpec(**kw), 0, device="cpu")
        want = {k: "data" if s == jax.sharding.PartitionSpec("data") else None
                for k, s in jmesh.batch_pspecs(jb).items()}
        assert tmesh.batch_pspecs(tb) == want


def test_initialize_multihost_without_a_coordinator_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.initialize_multihost() is False
    assert not torch.distributed.is_initialized()


@pytest.fixture
def one_rank():
    """make_mesh() in this process: a world-size-1 gloo group, destroyed
    after the test."""
    mesh = tmesh.make_mesh(device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def test_make_mesh_in_one_process_has_one_rank(one_rank):
    assert (one_rank.rank, one_rank.size, one_rank.axis_names) == (0, 1, ("data",))
    batch = tprob.make_batch(tprob.GPESpec(**LOSS), 0, device="cpu")
    local = tmesh.shard_batch(batch, one_rank)
    assert all(torch.equal(local[k], batch[k]) for k in batch)
    with pytest.raises(ValueError, match="2 devices"):
        tmesh.make_mesh(2, device="cpu")


def test_fit_mesh_refuses_a_gradient_that_is_not_psum_aware(one_rank):
    spec = tprob.GPESpec(**LOSS)
    loss_fn = tprob.make_loss_fn(spec)
    with pytest.raises(ValueError, match="psum-aware"):
        tloop.fit(loss_fn, make_optimizer("adam", 1e-3),
                  tprob.init_params(spec, device="cpu"),
                  tprob.make_batch(spec, 0, device="cpu"), 1.0, 0.01, epochs=2,
                  value_and_grad_fn=tloop.value_and_grad(loss_fn), mesh=one_rank)


def test_entry_points_refuse_the_other_kind_of_mesh(one_rank):
    """The collocation entry points take a "data" mesh and the ensemble
    ones an "ens" mesh; each raises on the other kind before it trains."""
    spec = tprob.GPESpec(**ENS)
    loss_fn = tprob.make_loss_fn(spec)
    batch = tprob.make_batch(spec, 0, device="cpu")
    ens = tmesh.make_mesh(axis="ens", device="cpu")
    assert ens.axis_names == ("ens",)
    with pytest.raises(ValueError, match="'data' mesh"):
        tloop.fit(loss_fn, make_optimizer("adam", 1e-3),
                  tprob.init_params(spec, device="cpu"), batch, 1.0, 0.01, epochs=2,
                  mesh=ens)
    params_b = params_from_numpy(_np_params(ENS["layers"], 1, 2), device="cpu")
    with pytest.raises(ValueError, match="'ens' mesh"):
        tloop.fit_ensemble(loss_fn, make_optimizer("adam", 1e-3), params_b, batch,
                           1.0, 1.0, epochs=2, mesh=one_rank)
    with pytest.raises(ValueError, match="'ens' mesh"):
        tmesh.make_ensemble_step(loss_fn, make_optimizer("adam", 1e-3), one_rank)
    pspec = tprob.GPESpec(**PACKED)
    with pytest.raises(ValueError, match="'ens' mesh"):
        tpacked.fit_ensemble_packed(
            pspec, params_from_numpy(_np_params(PACKED["layers"], 1, 4), device="cpu"),
            tprob.make_batch(pspec, 0, device="cpu"), 1.0, np.ones(4, np.float32),
            epochs=2, mesh=one_rank)


def _children():
    """(pid, command line) of every living child of this process."""
    out = set()
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == os.getpid():
                with open(f"/proc/{pid}/cmdline") as f:
                    out.add((pid, f.read().replace("\0", " ").strip()))
        except (OSError, ValueError, IndexError):
            continue
    return out


def _added(before, after) -> list:
    """The children in `after` whose pid is not in `before`. By pid: a child
    that was there before and ends during the call reads an empty command
    line as a zombie, but the call did not add it."""
    pids = {pid for pid, _ in before}
    return sorted(c for c in after if c[0] not in pids)


def test_spawn_leaves_no_process_running():
    """The ranks are joined and the resource tracker the spawn started for
    them is stopped: the call adds no child to this process. (A child that
    an earlier test left may end, or be reaped, during the call; that is
    not the spawn's, so only the added set is held.)"""
    before = _children()
    assert run_cases([], nprocs=2, backend="gloo", device="cpu") == [{}, {}]
    after = _children()
    assert not _added(before, after), (f"added {_added(before, after)}, "
                                       f"gone {sorted(before - after)}")


def test_spawn_stops_a_tracker_it_relaunched():
    """A resource tracker that was recorded but had died (here: killed) is
    reaped by the spawn, which starts a new one for the ranks; that one is
    the spawn's own and is stopped too: the call adds no child."""
    import signal
    import time
    from multiprocessing import resource_tracker

    resource_tracker.ensure_running()
    tracker = resource_tracker._resource_tracker
    os.kill(tracker._pid, signal.SIGKILL)
    time.sleep(0.2)
    before = _children()
    with pytest.warns(UserWarning, match="resource_tracker"):
        assert run_cases([], nprocs=2, backend="gloo", device="cpu") == [{}, {}]
    after = _children()
    assert not _added(before, after), f"added {_added(before, after)}"
    assert tracker._pid is None


@pytest.mark.parametrize("nprocs,slow", [(2, 1), (2, 0), (3, 2), (3, 0)])
def test_spawns_back_to_back_tear_down_after_the_slowest_rank(tmp_path, nprocs, slow):
    """Spawns back to back whose ranks run no collective, one rank 0.5 s
    slower than the rest: every rank returns its own result, and none
    tears the group down before the slowest has returned. (Without the
    spawn's barrier a fast rank closed its connections at once, and a peer
    still in gloo's connectFullMesh failed with "Connection closed by
    peer": 7 of 480 such spawns, eight processes side by side.)"""
    delays = [0.0] * nprocs
    delays[slow] = 0.5
    ranks = run_cases([("t", "teardown", dict(delays=delays, log=str(tmp_path)))],
                      nprocs=nprocs, backend="gloo", device="cpu")
    assert [(int(r["t/rank"]), int(r["t/size"])) for r in ranks] == \
        [(r, nprocs) for r in range(nprocs)]
    returned = max(float(r["t/returned"]) for r in ranks)
    torn = [float((tmp_path / f"destroy{r}").read_text()) for r in range(nprocs)]
    assert min(torn) >= returned, (torn, returned)
