"""The four time-dependent and vortex drivers of the port
(`gpe_tpu_torch/experiments/rotating_dynamics.py`, `gpe_dynamics.py`,
`gpe2d_vortex.py`, `gpe2d_vortex_config.py`) on the CPU:

- `fit_kohn_pair` and `fit_frequency` on synthetic signals, equal to the JAX
  package's functions and recovering the known frequencies;
- two faults of the JAX drivers, not inherited, each test failing against
  the JAX behaviour: the f32 resonance guard's fixed kinetic 0.5
  (`gpe_dynamics.py:225,230`) and the summary merge keyed on γ alone
  (`gpe2d_vortex.py:125-133`);
- rotating_dynamics and gpe_dynamics at smoke size against the JAX drivers
  run on the same arguments in float64 (every number to rel 1e-8 or abs
  1e-9; the Kohn stage runs 4 time units, past 2π/(ω₊ − ω₋), so that its
  fit is well posed);
- gpe2d_vortex and gpe2d_vortex_config at smoke size, into a temporary
  directory (nothing under runs/ is written).
"""
import json
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

from gpe_tpu.experiments import gpe_dynamics as jgd  # noqa: E402
from gpe_tpu.experiments import rotating_dynamics as jrd  # noqa: E402
from gpe_tpu_torch.experiments import gpe2d_vortex as tgv  # noqa: E402
from gpe_tpu_torch.experiments import gpe2d_vortex_config as tgvc  # noqa: E402
from gpe_tpu_torch.experiments import gpe_dynamics as tgd  # noqa: E402
from gpe_tpu_torch.experiments import rotating_dynamics as trd  # noqa: E402


def test_fit_kohn_pair_recovers_the_split_frequencies_as_jax():
    t = np.linspace(0.0, 25.0, 1200)
    om, d = 0.6, 0.4
    z = d * np.exp(-1j * om * t) * np.cos(t)
    z = z + 1e-6 * np.random.default_rng(0).standard_normal(t.size)
    got, want = trd.fit_kohn_pair(t, z, om), jrd.fit_kohn_pair(t, z, om)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    wp, wm, a, b, rms = got
    assert abs(wp - (1 + om)) < 1e-6 and abs(wm - (1 - om)) < 1e-6
    assert abs(a - d / 2) < 1e-6 and abs(b - d / 2) < 1e-6 and rms < 1e-5


def test_fit_frequency_recovers_omega_as_jax():
    t = np.linspace(0.0, 30.0, 2000)
    y = 0.3 + 0.2 * np.cos(2.0007 * t + 0.4)
    got, want = tgd.fit_frequency(t, y), jgd.fit_frequency(t, y)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert abs(got[0] - 2.0007) < 1e-8 and abs(got[1] - 0.2) < 1e-8


def _jax_guard_steps(t_end, steps, dx, dim):
    """The JAX driver's guard (gpe_dynamics.py:224-231): c fixed at 0.5."""
    kmax2 = dim * (np.pi / dx) ** 2
    dt_safe = 0.9 * np.pi / (0.5 * kmax2)
    return int(np.ceil(t_end / dt_safe)) if t_end / steps > dt_safe else steps


@pytest.mark.parametrize("kinetic", [0.5, 1.0, 2.0])
def test_resonance_guard_takes_the_kinetic_coefficient(kinetic):
    """Every mode's kinetic phase a step, dt·c·k²_corner, stays ≤ 0.9π for
    the run's own c; the JAX guard meets that only at c = 0.5."""
    t_end, dx, dim = 4 * 2 * np.pi, 24.0 / 256, 2
    phase = lambda steps: (t_end / steps) * kinetic * dim * (np.pi / dx) ** 2
    steps, rec = tgd.resonance_guard(t_end, 6000, dx, dim, kinetic)
    assert rec is not None and rec["kinetic"] == kinetic
    assert phase(steps) <= 0.9 * np.pi * (1 + 1e-12)
    assert phase(steps - 1) > 0.9 * np.pi            # the least such count
    jax_ok = phase(_jax_guard_steps(t_end, 6000, dx, dim)) <= 0.9 * np.pi * (1 + 1e-12)
    assert jax_ok == (kinetic <= 0.5)
    assert tgd.resonance_guard(t_end, 10 ** 6, dx, dim, kinetic) == (10 ** 6, None)


def _jax_merge(prev_summary, gamma, results):
    """The JAX driver's merge (gpe2d_vortex.py:125-133)."""
    if prev_summary.get("gamma") == gamma:
        fresh = {r["omega"] for r in results}
        return sorted([r for r in prev_summary.get("results", [])
                       if r["omega"] not in fresh] + results, key=lambda r: r["omega"])
    return results


def test_vortex_summary_merge_keys_on_every_setting():
    row = lambda om, g, width, mu: {"omega": om, "mu_net": mu, "settings": {
        "omega": om, "gamma": g, "width": width}}
    prev = [row(0.7, 50.0, 128, 1.0), row(0.0, 50.0, 128, 2.0), row(0.7, 40.0, 128, 3.0)]
    fresh = [row(0.7, 50.0, 64, 4.0), row(0.0, 50.0, 128, 5.0)]
    got = tgv.merge_rows(prev, fresh)
    mus = sorted(r["mu_net"] for r in got)
    assert mus == [1.0, 3.0, 4.0, 5.0]     # same settings replaced, the rest kept
    jax_mus = sorted(r["mu_net"] for r in _jax_merge(
        {"gamma": 50.0, "results": prev}, 50.0, fresh))
    assert jax_mus != mus                   # JAX drops the width-128 Ω 0.7 row
    assert sorted(r["mu_net"] for r in _jax_merge(
        {"gamma": 40.0, "results": prev}, 50.0, fresh)) == [4.0, 5.0]


def _close(got, want, path=""):
    """Nested summaries equal: numbers to rel 1e-8 or abs 1e-9, everything
    else exactly."""
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{path}[{i}]")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert math.isclose(got, want, rel_tol=1e-8, abs_tol=1e-9), (path, got, want)
    else:
        assert got == want, path


def test_rotating_dynamics_smoke_matches_the_jax_driver(tmp_path):
    args = ["--n", "48", "--spinup-steps", "600", "--record-every", "200",
            "--rt-steps", "100", "--kohn-steps", "400", "--rt-dt", "0.01"]
    jax.config.update("jax_platforms", "cpu")
    jrd.main(args + ["--out", str(tmp_path / "jax")])
    assert trd.main(args + ["--cpu", "--out", str(tmp_path / "port")]) == 0
    got = json.loads((tmp_path / "port" / "summary.json").read_text())
    want = json.loads((tmp_path / "jax" / "summary.json").read_text())
    for k in ("omega0_ground", "spinup_final", "nucleation_path", "stationarity",
              "kohn_splitting", "config", "dtype"):
        _close(got[k], want[k], k)
    assert got["backend"] == "cpu" and set(got["seconds"]) == {
        "omega0_ground", "spinup", "stationarity", "kohn_splitting"}


def test_gpe_dynamics_smoke_matches_the_jax_driver(tmp_path):
    args = ["--n", "32", "--steps", "400", "--gamma", "10", "--gs-steps", "600"]
    jgd.main(args + ["--out", str(tmp_path / "jax")])
    assert tgd.main(args + ["--cpu", "--out", str(tmp_path / "port")]) == 0
    got = json.loads((tmp_path / "port" / "summary.json").read_text())
    want = json.loads((tmp_path / "jax" / "summary.json").read_text())
    for k in ("mu_ground", "kohn_dipole", "breathing_2d", "norm_drift",
              "energy_drift_rel", "config", "dtype"):
        _close(got[k], want[k], k)
    # --f32: the guard raises 100 requested steps, and the summary embeds
    # the f64 run of the same out directory
    assert tgd.main(args[:2] + ["--steps", "100"] + args[4:] + [
        "--cpu", "--f32", "--out", str(tmp_path / "port")]) == 0
    f32 = json.loads((tmp_path / "port" / "summary_f32.json").read_text())
    assert f32["dtype"] == "complex64"
    assert f32["f32_resonance_guard"]["kinetic"] == tgd.KINETIC
    assert f32["f32_resonance_guard"]["steps"] > 100
    assert math.isfinite(f32["kohn_dipole"]["omega_fit"])
    assert "vs_f64_reference" in f32


def test_vortex_drivers_run_at_smoke_size(tmp_path):
    out = tmp_path / "v"
    args = ["--cpu", "--n", "20", "--width", "16", "--fit-epochs", "10",
            "--lbfgs-steps", "2", "--polish-steps", "1", "--cg-iters", "3",
            "--sobolev-n", "16", "--oracle-steps", "200", "--out", str(out)]
    assert tgv.main(args + ["--omegas", "0.0", "0.9"]) == 0
    assert tgv.main(args + ["--omegas", "0.9", "--width", "12"]) == 0
    rows = json.loads((out / "summary.json").read_text())["results"]
    assert [(r["omega"], r["settings"]["width"]) for r in rows] == [
        (0.0, 16), (0.9, 16), (0.9, 12)]
    assert all(math.isfinite(r["mu_net"]) for r in rows)
    cached = [r for r in rows if r["omega"] == 0.9]
    assert all(r["oracle_source"]["config"] == "v7" for r in cached)
    assert all(r["mu_grid"] == cached[0]["oracle_source"]["mu_star"] for r in cached)
    assert (out / "params_omega0.9.pkl").exists()

    cfg = tmp_path / "c"
    tgvc.stage_oracle(200, 100, 2e-3, str(cfg), {"a": (24, (28,))}, "cpu")
    table = json.loads((cfg / "config_oracle_table.json").read_text())
    assert [r["n"] for r in table["a"]["rows"]] == [24, 28]
    rec = tgvc.stage_net(20, 16, 10, 2, 1, cg_iters=3, sobolev_n=16, out=str(cfg),
                         device="cpu")
    assert set(rec["per_config"]) == {"a"} and (cfg / "config_matched.json").exists()
    assert math.isfinite(rec["per_config"]["a"]["mu_net"])


def test_vortex_driver_records_the_polish_and_its_seed(tmp_path):
    """Each row carries the polish's verdict (the kept net's pde is the
    after-polish pde exactly when it was accepted) and the seed of its
    initial draw; rows of two seeds both stay in the summary."""
    out = tmp_path / "v"
    args = ["--cpu", "--n", "20", "--width", "16", "--fit-epochs", "10",
            "--lbfgs-steps", "2", "--polish-steps", "2", "--cg-iters", "3",
            "--sobolev-n", "16", "--oracle-steps", "200", "--omegas", "0.7",
            "--out", str(out)]
    assert tgv.main(args) == 0 and tgv.main(args + ["--seed", "1"]) == 0
    rows = json.loads((out / "summary.json").read_text())["results"]
    assert [r["settings"]["seed"] for r in rows] == [0, 1]
    assert rows[0]["mu_net"] != rows[1]["mu_net"]
    for r in rows:
        p = r["polish"]
        kept = p["after"] if p["accepted"] else p["before"]
        assert p["accepted"] == (p["after"]["pde"] < p["before"]["pde"]
                                 and abs(p["after"]["lz"] - p["before"]["lz"]) < 0.2)
        assert (r["pde_loss"], r["mu_net"], r["lz_net"]) == (kept["pde"], kept["mu"],
                                                            kept["lz"])
