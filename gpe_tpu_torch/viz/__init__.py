"""The figure layer, port of `gpe_tpu/viz/`.

Gathering a figure's arrays is device work and runs where the run runs;
drawing is host work and runs wherever matplotlib is. Only `viz.plots`
imports matplotlib, so this package imports nothing of it: a figure site
asks `plots_or_none()` for the plotting module and records
`not_written(...)` where the host has no matplotlib, and the `--plots`
mode of the runner and of each driver draws the figure later from what
the run saved (its bundle, or a `<figure>.npz` beside its summary.json).
"""
from __future__ import annotations

import json
import os


def plots_or_none():
    """The `gpe_tpu_torch.viz.plots` module, or None where matplotlib is
    not installed on this host. Any other import error propagates."""
    try:
        from gpe_tpu_torch.viz import plots
    except ImportError as e:
        if (e.name or "").split(".")[0] != "matplotlib":
            raise
        return None
    return plots


def not_written(command: str) -> str:
    """The `plot` record of a figure left undrawn for want of matplotlib;
    `command` draws it on a host that has matplotlib."""
    return (f"not written: matplotlib is not installed on this host; run {command} "
            "on a host that has it")


def draw(draw_fn, command: str):
    """The file names of the paths `draw_fn(plots)` writes, or
    `not_written(command)` where matplotlib is not installed."""
    plots = plots_or_none()
    if plots is None:
        return not_written(command)
    return [os.path.basename(p) for p in draw_fn(plots)]


def saved(path: str) -> str:
    """`path`, a file a run saved for `--plots` to draw from;
    FileNotFoundError naming it when it is not there."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"--plots draws from {path}, which does not exist: "
                                "make the run that writes it first")
    return path


def draw_saved(draw_fn, **record) -> list:
    """`--plots`: `draw_fn(plots)` (matplotlib required); prints the JSON
    line `record` with `plot`, the file names written, and returns them."""
    from gpe_tpu_torch.viz import plots

    files = [os.path.basename(p) for p in draw_fn(plots)]
    print(json.dumps({**record, "plot": files}), flush=True)
    return files
