"""The port's figure layer (`gpe_tpu_torch/viz/`, `experiments/
combined_plots.py`, the figures of the runner and of the drivers) against
the JAX package's, on the CPU.

Pixels: every render starts from `matplotlib.rcdefaults()`, so the order
of the tests decides nothing, and PNGs are compared as
`matplotlib.image.imread` arrays, never as bytes. Identical inputs give
identical pixels (both packages draw with one matplotlib in one process).
The wavefunction gather (the net on `make_batch`'s grid) is held to the
JAX runner's arrays at 1e-5 (f32 forward passes on two libraries).
"""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from gpe_tpu.experiments import combined_plots as jcp  # noqa: E402
from gpe_tpu.experiments import run as jrun  # noqa: E402
from gpe_tpu.experiments.configs import EXPERIMENTS as JEXPERIMENTS  # noqa: E402
from gpe_tpu.io import load_bundle as jload  # noqa: E402
from gpe_tpu_torch import viz  # noqa: E402
from gpe_tpu_torch.experiments import combined_plots as tcp  # noqa: E402
from gpe_tpu_torch.experiments import (gpe2d_flagship, gpe2d_vortex,  # noqa: E402
                                       gpe3d_ground_state, gpe_dynamics,
                                       rotating_dynamics, run)
from gpe_tpu_torch.experiments.configs import EXPERIMENTS  # noqa: E402
from gpe_tpu_torch.io import load_bundle  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _mpl():
    return pytest.importorskip("matplotlib")


def _pixels(path):
    from matplotlib import image
    return image.imread(str(path))


def _same_pixels(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape and np.array_equal(pa, pb), (a, b)


def _render(fn):
    """fn() from matplotlib's default rcParams."""
    _mpl().rcdefaults()
    return fn()


# ---- (i) every viz/plots.py function, the same seeded inputs in both packages

def _case_inputs(name, rng):
    x = np.linspace(-5, 5, 64)
    if name == "wavefunctions":
        u = {m: {g: np.exp(-x * x / (1 + g)) * x ** m * (1 + 0.1 * rng.standard_normal())
                 for g in (0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0, 16.0)}
             for m in (0, 1, 2, 3, 4)}
        return (x, u), dict(normalize_dx=float(x[1] - x[0]), every=2)
    if name == "mu_vs_gamma":
        tab = {m: [(float(g), float(2 * m + 1 + g ** 0.7 + 0.01 * rng.standard_normal()))
                   for g in np.linspace(0, 20, 21)] for m in (0, 1, 2)}
        return (tab,), dict(every=2, xlabel="β")
    if name == "loss_history":
        hist = {m: {float(g): {"loss": np.abs(rng.standard_normal(200)) * np.logspace(0, -4, 200)}
                    for g in (0.0, 1.0, 2.0)} for m in (0, 1, 2, 3)}
        return (hist,), dict(smooth=5)
    if name == "epochs_heatmap":
        eh = {m: {float(g): int(rng.integers(100, 5000)) for g in np.linspace(0, 10, 6)}
              for m in range(4)}
        return (eh,), dict(xlabel="β")
    if name == "method_comparison":
        h = {k: np.abs(rng.standard_normal(150)) * np.logspace(0, -3, 150)
             for k in ("PL-PINN", "vanilla", "curriculum")}
        bands = {"PL-PINN": (h["PL-PINN"], 0.1 * h["PL-PINN"])}
        return (h,), dict(bands=bands)
    if name in ("solution_2d", "solution_2d_ref"):
        g = np.linspace(-3, 3, 24)
        X, Y = np.meshgrid(g, g, indexing="ij")
        xy = np.stack([X.ravel(), Y.ravel()], -1)
        u = np.exp(-(X ** 2 + Y ** 2) / 2).ravel() + 0.01 * rng.standard_normal(xy.shape[0])
        kw = {"u_ref": np.exp(-(X ** 2 + Y ** 2) / 2).ravel()} if name.endswith("ref") else {}
        return (xy, u), kw
    if name == "thomas_fermi_overlay":
        # V in float32, as the port's batches carry it (the JAX package,
        # without x64, computes ψ_TF in float32 whatever it is given)
        V = (x * x).astype(np.float32)
        return (x, np.sqrt(np.clip((10.0 - x * x) / 20.0, 0, None)), 10.0, V, 20.0), {}
    if name == "mode0_cross_potential":
        loss = {k: np.abs(rng.standard_normal(120)) * np.logspace(1, -5, 120)
                for k in ("harmonic", "box", "gravity_well", "gaussian")}
        return (loss,), dict(smooth=9)
    raise KeyError(name)


PLOT_CASES = ("wavefunctions", "mu_vs_gamma", "loss_history", "epochs_heatmap",
              "method_comparison", "solution_2d", "solution_2d_ref",
              "thomas_fermi_overlay", "mode0_cross_potential")


@pytest.mark.parametrize("name", PLOT_CASES)
def test_every_plotter_draws_jax_pixels(name, tmp_path):
    _mpl()
    from gpe_tpu.viz import plots as jplots
    from gpe_tpu_torch.viz import plots as tplots

    fn = "plot_" + name.removesuffix("_ref")
    paths = {}
    for label, mod in (("jax", jplots), ("port", tplots)):
        args, kw = _case_inputs(name, np.random.default_rng(0))

        def draw(mod=mod, args=args, kw=kw, out=tmp_path / label):
            mod.use_publication_style()
            return getattr(mod, fn)(*args, save_dir=str(out), **kw)
        paths[label] = _render(draw)
    assert Path(paths["jax"]).name == Path(paths["port"]).name
    _same_pixels(paths["jax"], paths["port"])


def test_publication_style_sets_jax_rcparams():
    mpl = _mpl()
    from gpe_tpu.viz import plots as jplots
    from gpe_tpu_torch.viz import plots as tplots

    got = {}
    for label, mod in (("jax", jplots), ("port", tplots)):
        mpl.rcdefaults()
        mod.use_publication_style()
        got[label] = dict(mpl.rcParams)
    mpl.rcdefaults()
    assert got["jax"] == got["port"] and got["port"]["savefig.dpi"] == 300
    assert mpl.get_backend().lower() == "agg"


# ---- (iii) the wavefunction gather against the JAX runner's arrays

WAVEFUNCTION_RUNS = ("gpe1d_tf", "harmonic_quick", "linear_1d_sanity", "plpinn_sharded_dp")


class _Capture:
    """A stand-in for the JAX runner's `viz` that keeps what
    `_plot_wavefunctions_from_bundle` would draw."""

    def plot_wavefunctions(self, x, u_by, out_dir):
        self.x, self.u_by = x, u_by


@pytest.mark.parametrize("name", WAVEFUNCTION_RUNS)
def test_wavefunction_gather_matches_jax(name, tmp_path):
    bundle_path = ROOT / "runs" / name / "bundle.pkl"
    cap = _Capture()
    jrun._plot_wavefunctions_from_bundle(JEXPERIMENTS[name], jload(str(bundle_path)),
                                         str(tmp_path), cap)
    x, u_by = run.wavefunctions_from_bundle(EXPERIMENTS[name], load_bundle(str(bundle_path)),
                                            "cpu")
    # the port builds its grids in float64 and stores float32: an ulp off
    # JAX's float32 linspace at some points
    np.testing.assert_allclose(x, np.asarray(cap.x), rtol=0, atol=1e-5)
    assert {m: sorted(v) for m, v in u_by.items()} == \
        {m: sorted(v) for m, v in cap.u_by.items()}
    for m, by_g in cap.u_by.items():
        for g, want in by_g.items():
            assert u_by[m][g].shape == np.asarray(want).shape
            np.testing.assert_allclose(u_by[m][g], np.asarray(want), rtol=0, atol=1e-5,
                                       err_msg=f"{name} mode {m} γ {g}")
    if name == "harmonic_quick":
        _mpl()
        from gpe_tpu.viz import plots as jplots
        from gpe_tpu_torch.viz import plots as tplots

        paths = [_render(lambda mod=mod, d=d: (mod.use_publication_style(),
                                               mod.plot_wavefunctions(cap.x, cap.u_by,
                                                                      str(tmp_path / d)))[1])
                 for mod, d in ((jplots, "jax"), (tplots, "port"))]
        _same_pixels(*paths)


def test_wavefunction_gather_is_none_off_1d():
    bundle = load_bundle(str(ROOT / "runs" / "gpe2d_ground_state" / "bundle.pkl"))
    assert run.wavefunctions_from_bundle(EXPERIMENTS["gpe2d_ground_state"], bundle,
                                         "cpu") is None


# ---- (iv) combined_plots on the committed tables

def test_combined_plots_match_jax(tmp_path, monkeypatch):
    """The JAX script on the committed runs/ CSVs, and the port's with its
    default --runs (runs_torch) holding copies of them."""
    _mpl()
    _render(lambda: jcp.main(["--runs", str(ROOT / "runs"), "--out", str(tmp_path / "jax")]))
    for fam, _ in tcp.FAMILIES:
        d = f"comparison_results_{fam}"
        (tmp_path / "runs_torch" / d).mkdir(parents=True)
        shutil.copy(ROOT / "runs" / d / "raw_comparison_results.csv",
                    tmp_path / "runs_torch" / d)
    monkeypatch.chdir(tmp_path)
    _render(lambda: tcp.main([]))
    port = tmp_path / "runs_torch" / "comparison_results_combined_all_potentials"
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in port.iterdir()) and len(names) == 3
    for n in names:
        _same_pixels(tmp_path / "jax" / n, port / n)


# ---- (v) the figures drawn from a run's saved .npz

class _Figures:
    """Keeps each figure a draw function closes, to read its artists."""

    def __init__(self, monkeypatch):
        from gpe_tpu_torch.viz import plots
        self.figs, close = [], plots.plt.close
        monkeypatch.setattr(plots.plt, "close",
                            lambda fig=None: (self.figs.append(fig), close(fig)))


def _lines(ax):
    return [ln.get_xydata() for ln in ax.get_lines()]


def test_quench_modes_drawn_from_npz(tmp_path, monkeypatch):
    _mpl()
    from gpe_tpu_torch.viz import plots
    rng = np.random.default_rng(1)
    t = np.linspace(0, 25, 101)
    arrays = dict(t_k=t, cx=0.5 * np.cos(t) + 1e-3 * rng.standard_normal(101), d=0.5,
                  w_dip=1.0000123456, t_b=t, w2=1 + 0.1 * np.cos(2 * t), w_br=1.99987654)
    np.savez(tmp_path / "quench_modes.npz", **arrays)
    figs = _Figures(monkeypatch)
    assert _render(lambda: gpe_dynamics.draw_quench_modes(str(tmp_path), plots)) == \
        [str(tmp_path / "quench_modes.png")]
    ax0, ax1 = figs.figs[-1].axes
    np.testing.assert_array_equal(_lines(ax0)[0], np.stack([t, arrays["cx"]], 1))
    np.testing.assert_array_equal(_lines(ax0)[1], np.stack([t, 0.5 * np.cos(t)], 1))
    np.testing.assert_array_equal(_lines(ax1)[0], np.stack([t, arrays["w2"]], 1))
    assert ax0.get_title() == f"dipole: $\\omega$={1.0000123456:.6f} (exact 1)"
    assert ax1.get_title() == f"breathing: $\\omega$={1.99987654:.6f} (exact 2)"
    assert _pixels(tmp_path / "quench_modes.png").size > 0


def test_rotating_dynamics_drawn_from_npz(tmp_path, monkeypatch):
    _mpl()
    from gpe_tpu_torch.viz import plots
    rng = np.random.default_rng(2)
    t = np.linspace(0, 4, 41)
    arrays = dict(tau_t=[0.4, 0.8, 1.2], lz=[0.1, 0.5, 2.0], n_vortices=[0, 1, 3],
                  density=rng.random((12, 12)), lb=-8.0, omega=0.9, t=t,
                  cx=0.5 * np.cos(t), x_pred=0.5 * np.cos(t) * np.cos(0.9 * t))
    np.savez(tmp_path / "rotating_dynamics.npz", **arrays)
    figs = _Figures(monkeypatch)
    _render(lambda: rotating_dynamics.draw_rotating_dynamics(str(tmp_path), plots))
    ax0, ax1, ax2, twin = figs.figs[-1].axes
    np.testing.assert_array_equal(_lines(ax0)[0], np.stack([arrays["tau_t"], arrays["lz"]], 1))
    np.testing.assert_array_equal(_lines(twin)[0],
                                  np.stack([arrays["tau_t"], arrays["n_vortices"]], 1))
    np.testing.assert_array_equal(ax1.get_images()[0].get_array(), arrays["density"].T)
    assert ax1.get_images()[0].get_extent() == [-8.0, 8.0, -8.0, 8.0]
    np.testing.assert_array_equal(_lines(ax2)[1], np.stack([t, arrays["x_pred"]], 1))
    assert ax0.get_title() == f"spin-up Ω=0→{0.9}"
    assert ax1.get_title() == f"|ψ|² final ({3} vortices)"
    assert (tmp_path / "rotating_dynamics.png").stat().st_size > 0


def test_vortex_rows_drawn_from_npz(tmp_path, monkeypatch):
    _mpl()
    from gpe_tpu_torch.viz import plots
    rng = np.random.default_rng(3)
    psis = {}
    for omega in (0.0, 0.7):
        psis[omega] = rng.standard_normal((10, 10)) + 1j * rng.standard_normal((10, 10))
        np.savez(tmp_path / f"vortex_omega{omega:g}.npz", psi=psis[omega], lb=-8.0, ub=8.0,
                 omega=omega)
    figs = _Figures(monkeypatch)
    assert _render(lambda: gpe2d_vortex.draw_vortices(str(tmp_path), plots)) == \
        [str(tmp_path / "vortex_omega0.png"), str(tmp_path / "vortex_omega0.7.png")]
    for fig, omega in zip(figs.figs, (0.0, 0.7)):
        a0, a1 = fig.axes[:2]
        np.testing.assert_allclose(a0.get_images()[0].get_array(),
                                   np.abs(psis[omega]).T ** 2, rtol=0, atol=0)
        np.testing.assert_array_equal(a1.get_images()[0].get_array(), np.angle(psis[omega]).T)
        assert a1.get_images()[0].get_cmap().name == "twilight"
        assert (a0.get_title(), a1.get_title()) == (f"|ψ|²  Ω={omega}", "arg ψ")
    with pytest.raises(FileNotFoundError, match="vortex_omega"):
        gpe2d_vortex.draw_vortices(str(tmp_path / "empty"), plots)


@pytest.mark.parametrize("driver", ["flagship", "midplane"])
def test_solution_figures_drawn_from_npz(driver, tmp_path, monkeypatch):
    _mpl()
    from gpe_tpu_torch.viz import plots
    g = np.linspace(-4, 4, 9)
    X, Y = np.meshgrid(g, g, indexing="ij")
    xy = np.stack([X.ravel(), Y.ravel()], -1)
    u = np.exp(-(X ** 2 + Y ** 2)).ravel()
    if driver == "flagship":
        np.savez(tmp_path / "flagship_solution.npz", xy=xy, u=u)
        draw, png = gpe2d_flagship.draw_flagship_solution, "flagship_solution.png"
    else:
        np.savez(tmp_path / "midplane_z0.npz", pts=xy, u=u)
        draw, png = gpe3d_ground_state.draw_midplane, "midplane_z0.png"
    figs = _Figures(monkeypatch)
    assert _render(lambda: draw(str(tmp_path), plots)) == [str(tmp_path / png)]
    ax = figs.figs[-1].axes[0]
    np.testing.assert_array_equal(np.asarray(ax.collections[0].get_array()).ravel(),
                                  np.abs(u.reshape(9, 9)).ravel())
    assert ax.get_title() == "|ψ|"


def test_runner_npz_figures_drawn_from_npz(tmp_path, monkeypatch):
    """optimizer_comparison.png and deeponet_heldout.png from their .npz."""
    _mpl()
    from gpe_tpu_torch.viz import plots
    rng = np.random.default_rng(4)
    names = ["adam", "lbfgs"]
    loss = {f"loss_{n}": np.abs(rng.standard_normal(30)) + 1e-3 for n in names}
    np.savez(tmp_path / "optimizer_comparison.npz", names=np.asarray(names), **loss)
    x = np.linspace(-5, 5, 40)
    beta = np.array([0.45, 0.6, 0.77, 1.0, 2.1])
    u_pred = np.exp(-beta[:, None] * x[None] ** 2)
    np.savez(tmp_path / "deeponet_heldout.npz", beta=beta, mu_ref=np.sqrt(beta),
             mu_pred=np.sqrt(beta) + 1e-3, u_pred=u_pred, x=x)
    figs = _Figures(monkeypatch)
    _render(lambda: run.draw_optimizer_comparison(str(tmp_path), plots))
    ax = figs.figs[-1].axes[0]
    assert [ln.get_label() for ln in ax.get_lines()] == names
    for ln, n in zip(ax.get_lines(), names):
        np.testing.assert_array_equal(ln.get_ydata(), loss[f"loss_{n}"])
    _render(lambda: run.draw_deeponet_heldout(str(tmp_path), plots))
    a0, a1 = figs.figs[-1].axes
    np.testing.assert_array_equal(_lines(a0)[0], np.stack([beta, np.sqrt(beta)], 1))
    np.testing.assert_array_equal(_lines(a0)[1], np.stack([beta, np.sqrt(beta) + 1e-3], 1))
    assert a0.get_title() == "held-out potentials"
    assert [ln.get_label() for ln in a1.get_lines()] == \
        [rf"$\beta$={beta[i]:.2f}" for i in (0, 2, 4)]
    dx = x[1] - x[0]
    np.testing.assert_allclose(a1.get_lines()[0].get_ydata(),
                               u_pred[0] / np.sqrt(np.sum(u_pred[0] ** 2) * dx), rtol=1e-15)
    assert sorted(p.name for p in tmp_path.glob("*.png")) == [
        "deeponet_heldout.png", "optimizer_comparison.png"]


def test_plots_mode_names_what_is_missing(tmp_path):
    with pytest.raises(FileNotFoundError, match="harmonic_quick/bundle.pkl"):
        run.main(["harmonic_quick", "--plots", "--cpu", "--out", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="deeponet_heldout.npz"):
        run.main(["deeponet_harmonic", "--plots", "--cpu", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="draws no figure"):
        run.main(["gpe2d_circle", "--plots", "--cpu", "--out", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="quench_modes.npz"):
        gpe_dynamics.main(["--plots", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


# ---- (vi) a host without matplotlib

NO_MPL = """
import json, sys
sys.modules["matplotlib"] = None
import gpe_tpu_torch
from gpe_tpu_torch import viz
from gpe_tpu_torch.experiments import (combined_plots, gpe2d_flagship, gpe2d_vortex,
                                       gpe3d_ground_state, gpe_dynamics, rotating_dynamics,
                                       run)
assert viz.plots_or_none() is None
out = sys.argv[1]
assert run.main(["linear_1d_sanity", "--cpu", "--train", "--epochs", "20", "--pretrain",
                 "20", "--out", out]) == 0
assert gpe_dynamics.main(["--cpu", "--n", "16", "--steps", "100", "--gamma", "5",
                          "--gs-steps", "200", "--out", out + "/gd"]) == 0
try:
    run.main(["linear_1d_sanity", "--plots", "--cpu", "--out", out])
except ImportError as e:
    print(json.dumps({"plots_error": e.name}))
"""


def test_the_port_runs_where_matplotlib_is_not(tmp_path):
    """With matplotlib made unimportable: the package, the runner and the
    six drivers import; a tiny run writes its bundle and a `plot` record
    naming the reason and the command; the dynamics driver saves its
    .npz; `--plots` there fails on the import. Then `--plots` here draws
    what they saved."""
    out = tmp_path / "runs"
    proc = subprocess.run([sys.executable, "-c", NO_MPL, str(out)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"plots_error": "matplotlib"}
    rec = json.loads((out / "linear_1d_sanity" / "summary.json").read_text())
    assert rec["plot"] == viz.not_written(
        f"python -m gpe_tpu_torch.experiments.run linear_1d_sanity --plots --out {out} [--cpu]")
    assert sorted(p.name for p in (out / "linear_1d_sanity").iterdir()) == [
        "bundle.pkl", "summary.json"]
    gd = json.loads((out / "gd" / "summary.json").read_text())
    assert gd["plot"].startswith("not written: matplotlib is not installed on this host; "
                                 "run python -m gpe_tpu_torch.experiments.gpe_dynamics --plots")
    assert sorted(p.name for p in (out / "gd").iterdir()) == ["quench_modes.npz",
                                                              "summary.json"]
    _mpl()
    assert _render(lambda: run.main(["linear_1d_sanity", "--plots", "--cpu", "--out",
                                     str(out)])) == 0
    assert _render(lambda: gpe_dynamics.main(["--plots", "--out", str(out / "gd")])) == 0
    assert sorted(p.name for p in (out / "linear_1d_sanity").glob("*.png")) == [
        "epochs_heatmap.png", "loss_history.png", "mu_vs_gamma.png", "wavefunctions.png"]
    assert (out / "gd" / "quench_modes.png").stat().st_size > 0


def test_matplotlib_is_imported_only_by_viz_plots():
    pattern = re.compile(r"^\s*(import matplotlib|from matplotlib)", re.M)
    found = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "gpe_tpu_torch").rglob("*.py")
                   if pattern.search(p.read_text()))
    assert found == [os.path.join("gpe_tpu_torch", "viz", "plots.py")]
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())
