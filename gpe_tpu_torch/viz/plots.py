"""Evaluation and visualization suite, port of `gpe_tpu/viz/plots.py`
(reference L5, SURVEY.md §2.F rows F1-F9).

The one module of the port that imports matplotlib (Agg backend): import
it where a figure is drawn, never where arrays are gathered, so the port
runs on a host without matplotlib (`gpe_tpu_torch.viz.plots_or_none`).
Every plotter takes numpy arrays (a tensor is moved with
`.detach().cpu().numpy()` by its caller) and writes a PNG;
`use_publication_style` reproduces the reference's rcParams block
(harmonic_pinn_simulation.py:17-38). The figures are the JAX package's:
the same axes, titles, labels, colour maps and dpi.
"""
from __future__ import annotations

import os

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def use_publication_style():
    """Reference publication rcParams (dpi 300, enlarged fonts/ticks)."""
    plt.rcParams.update({
        "figure.dpi": 150, "savefig.dpi": 300,
        "font.size": 12, "axes.titlesize": 14, "axes.labelsize": 13,
        "xtick.labelsize": 11, "ytick.labelsize": 11, "legend.fontsize": 10,
        "xtick.direction": "in", "ytick.direction": "in",
        "xtick.major.size": 5, "ytick.major.size": 5,
        "axes.linewidth": 1.0, "lines.linewidth": 1.6,
    })


def _savefig(fig, save_dir, name):
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, name)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_wavefunctions(x, u_by_mode_gamma: dict, save_dir=".", fname="wavefunctions.png",
                       normalize_dx: float | None = None, every: int = 4):
    """F1: per-mode wavefunction grid, one curve per γ (subsampled `every`).

    u_by_mode_gamma: {mode: {gamma: u array}}. mode 0 is plotted as |u|,
    matching the reference's abs() for the nodeless ground state."""
    modes = sorted(u_by_mode_gamma)
    ncols = min(4, len(modes))
    nrows = -(-len(modes) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False)
    x = np.asarray(x).ravel()
    for i, mode in enumerate(modes):
        ax = axes[i // ncols][i % ncols]
        gammas = sorted(u_by_mode_gamma[mode])
        for g in gammas[::every]:
            u = np.asarray(u_by_mode_gamma[mode][g]).ravel()
            if normalize_dx is not None:
                u = u / np.sqrt(np.sum(u * u) * normalize_dx)
            if mode == 0:
                u = np.abs(u)
            ax.plot(x, u, label=f"γ={g:g}")
        ax.set_title(f"mode {mode}")
        ax.set_xlabel("x")
        ax.set_ylabel("ψ")
        if len(gammas[::every]) <= 8:
            ax.legend(fontsize=7)
    return _savefig(fig, save_dir, fname)


def plot_mu_vs_gamma(mu_table: dict, save_dir=".", fname="mu_vs_gamma.png",
                     every: int = 4, xlabel="γ"):
    """F2: μ-vs-γ (or μ-vs-β) spectrum curves, one marker series per mode."""
    fig, ax = plt.subplots(figsize=(6, 4.5))
    markers = "osv^D*Ph"
    for i, mode in enumerate(sorted(mu_table)):
        pairs = mu_table[mode][::every]
        g = [p[0] for p in pairs]
        mu = [p[1] for p in pairs]
        ax.plot(g, mu, marker=markers[i % len(markers)], ms=4, label=f"mode {mode}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel("μ")
    ax.legend()
    return _savefig(fig, save_dir, fname)


def plot_loss_history(training_history: dict, save_dir=".", fname="loss_history.png",
                      smooth: int = 1):
    """F3: loss-vs-epoch per mode (all γ curves overlaid, log-y); optional
    moving-average smoothing like the reference's moving_average."""
    modes = sorted(training_history)
    ncols = min(3, len(modes))
    nrows = -(-len(modes) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(5 * ncols, 3.5 * nrows), squeeze=False)
    for i, mode in enumerate(modes):
        ax = axes[i // ncols][i % ncols]
        for g, hist in sorted(training_history[mode].items()):
            loss = np.asarray(hist["loss"])
            if smooth > 1 and loss.size > smooth:
                loss = np.convolve(loss, np.ones(smooth) / smooth, mode="valid")
            ax.semilogy(loss, alpha=0.6, lw=0.8)
        ax.set_title(f"mode {mode}")
        ax.set_xlabel("epoch")
        ax.set_ylabel("total loss")
    return _savefig(fig, save_dir, fname)


def plot_epochs_heatmap(epochs_history: dict, save_dir=".", fname="epochs_heatmap.png",
                        xlabel="γ"):
    """F4: epochs-to-convergence heatmap over (mode × γ)."""
    modes = sorted(epochs_history)
    gammas = sorted(next(iter(epochs_history.values())))
    M = np.array([[epochs_history[m].get(g, np.nan) for g in gammas] for m in modes], float)
    fig, ax = plt.subplots(figsize=(8, 0.6 * len(modes) + 2))
    im = ax.imshow(M, aspect="auto", cmap="viridis",
                   extent=[gammas[0], gammas[-1], modes[-1] + 0.5, modes[0] - 0.5])
    ax.set_xlabel(xlabel)
    ax.set_ylabel("mode")
    ax.set_yticks(modes)
    fig.colorbar(im, label="epochs to converge")
    return _savefig(fig, save_dir, fname)


def plot_method_comparison(histories: dict, save_dir=".", fname="method_comparison.png",
                           bands: dict | None = None):
    """F5: PL-PINN vs vanilla vs curriculum loss curves (log-y); optional
    median±std bands from multi-seed runs ({method: (median, std)})."""
    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    for name, loss in histories.items():
        loss = np.asarray(loss)
        ax.semilogy(loss, label=name)
        if bands and name in bands:
            med, std = bands[name]
            e = np.arange(len(med))
            ax.fill_between(e, np.maximum(med - std, 1e-16), med + std, alpha=0.25)
    ax.set_xlabel("epoch")
    ax.set_ylabel("total loss")
    ax.legend()
    return _savefig(fig, save_dir, fname)


def plot_solution_2d(xy, u, save_dir=".", fname="solution_2d.png", u_ref=None,
                     title="|ψ|"):
    """F7: 2D solution contour (+ optional |error| panel vs a reference)."""
    xy = np.asarray(xy)
    n = int(round(np.sqrt(xy.shape[0])))
    X = xy[:, 0].reshape(n, n)
    Y = xy[:, 1].reshape(n, n)
    U = np.asarray(u).reshape(n, n)
    panels = 1 if u_ref is None else 2
    fig, axes = plt.subplots(1, panels, figsize=(5.5 * panels, 4.4), squeeze=False)
    im = axes[0][0].pcolormesh(X, Y, np.abs(U), shading="auto", cmap="viridis")
    axes[0][0].set_title(title)
    fig.colorbar(im, ax=axes[0][0])
    if u_ref is not None:
        E = np.abs(U - np.asarray(u_ref).reshape(n, n))
        im2 = axes[0][1].pcolormesh(X, Y, E, shading="auto", cmap="magma")
        axes[0][1].set_title("|ψ − ψ_ref|")
        fig.colorbar(im2, ax=axes[0][1])
    for ax in axes[0]:
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_aspect("equal")
    return _savefig(fig, save_dir, fname)


def plot_thomas_fermi_overlay(x, u_pinn, mu, V, gamma, save_dir=".",
                              fname="tf_overlay.png"):
    """F8: PINN density vs Thomas-Fermi approximation at the same μ."""
    import torch

    from gpe_tpu_torch.physics.thomas_fermi import thomas_fermi
    x = np.asarray(x).ravel()
    psi_tf = thomas_fermi(mu, torch.as_tensor(np.asarray(V)), gamma).numpy()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(x, np.abs(np.asarray(u_pinn).ravel()), label="PINN |ψ|")
    ax.plot(x, psi_tf, "--", label="Thomas-Fermi")
    ax.set_xlabel("x")
    ax.set_ylabel("|ψ|")
    ax.set_title(f"γ={gamma:g}, μ={mu:.4f}")
    ax.legend()
    return _savefig(fig, save_dir, fname)


def plot_mode0_cross_potential(loss_by_potential: dict, save_dir=".",
                               fname="mode0_cross_potential.png", smooth: int = 1):
    """F6: cross-potential mode-0 loss comparison — overlays the mode-0 loss
    curves of several potentials' bundles on one log-y axis (reference:
    final/refine/mode_0_loss_for_all_potentials.py:41-138, which loads the
    harmonic/box/gravity-well/gaussian pickles and overlays them).

    loss_by_potential: {potential_label: 1-D loss history array}.
    """
    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    for label, loss in sorted(loss_by_potential.items()):
        loss = np.asarray(loss)
        if smooth > 1 and loss.size > smooth:
            loss = np.convolve(loss, np.ones(smooth) / smooth, mode="valid")
        ax.semilogy(loss, lw=1.0, label=str(label))
    ax.set_xlabel("epoch")
    ax.set_ylabel("mode-0 total loss")
    ax.legend()
    return _savefig(fig, save_dir, fname)
