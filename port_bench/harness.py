"""What every cell shares: finding a cell's files by the names in
BENCHMARK.json, building the port's problem and the seeded inputs, reading
the metrics, and the checks on the process that prints the result.

A cell is BENCHMARK.json's `workloads` entry; its configuration file (the
`configs` entry's `file`) and its traffic file `port_bench/traffic/
<traffic>.json` are data. The traffic file names its `driver`, a module of
`port_bench/drivers/` with setup(cell) -> state, window(cell, state,
seconds, trace) -> record and check(cell, state, record) -> readings; the
readings' limits are `port_bench/limits/<cell>.json`; each metric is read
by `port_bench/metrics/<metric>.py`'s read(record). The configuration names
its plain reference, a module `port_bench/<reference>.py` with the API of
`port_bench/reference.py`, so a problem that module does not cover (another
dimension, potential or base) comes with a reference module of its own.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpe_tpu")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: object               # torch.device
    root: Path


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(root: Path, name: str, seed: int, device) -> Cell:
    bench = load_benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(wl)})")
    w = wl[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = HERE / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Cell(name, w, config, traffic, limits, seed, device, root)


def metrics_of(root: Path, name: str, trace: bool) -> list:
    """The metric entries this cell reports: the end-to-end ones untraced,
    the per-layer ones traced, each where its `workloads` (if any) has it."""
    bench = load_benchmark(root)
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def read_metric(metric: str, record: dict):
    """`port_bench/metrics/<metric>.py`'s read(record): a number, or None
    where the record holds nothing it reads."""
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_"), HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def driver(cell: Cell):
    return importlib.import_module(f"port_bench.drivers.{cell.traffic['driver']}")


def reference_of(cell: Cell):
    """The configuration's plain reference module (its `reference` key)."""
    return importlib.import_module(f"port_bench.{cell.config['reference']}")


# --------------------------------------------------------------------------
# the inputs, made from the seed


def seeded_params(layers, seed: int, device):
    """Xavier-uniform weights (bias 0.01), the scheme of the port's
    `init_mlp`, drawn in one call from a generator on `device`."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    sizes = [k * m for k, m in zip(layers[:-1], layers[1:])]
    u = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32)
    params, off = [], 0
    for (k, m), sz in zip(zip(layers[:-1], layers[1:]), sizes):
        lim = math.sqrt(6.0 / (k + m))
        W = ((u[off:off + sz] * 2.0 - 1.0) * lim).reshape(k, m).contiguous()
        params.append((W, torch.full((m,), 0.01, device=device)))
        off += sz
    return tuple(params)


COLLOCATION = ("x", "w", "V", "base_val", "base_grad", "base_lap")


def base_data(root: Path, config: dict):
    """(psi, xi, dx) of a numeric base's frozen data file, else None."""
    if config["spec"]["basis"] != "numeric":
        return None
    import numpy as np

    d = np.load(root / config["base_file"])
    return np.asarray(d["psi"]), np.asarray(d["xi"]), float(d["dx"])


def reference_problem(cell: Cell, n_side: int, dtype=None):
    import torch

    return reference_of(cell).Problem(cell.config["spec"], n_side, cell.device,
                                      base_data(cell.root, cell.config),
                                      dtype=dtype or torch.float64)


def perturb_scale(params, cell: Cell, n_side: int) -> float:
    """q-scale = 0.01 / max|N(x)| over the collocation points
    (train_plpinn's 0.01 / max N after pretraining; the absolute value keeps
    an untrained net's perturbation at 0.01 whatever its sign), from the
    reference's float64 forward on its own points, rounded to float32 as
    the port takes it."""
    import numpy as np
    import torch

    ref = reference_of(cell)
    p64 = tuple((W.double(), b.double()) for W, b in params)
    with torch.no_grad():
        x = ref.points(cell.config["spec"], n_side, cell.device)
        m = float(torch.max(torch.abs(ref.net_value(p64, x))))
    return float(np.float32(0.01 / m))


def program_problem(cell: Cell, n_side: int):
    """The port's GPESpec and batch for this configuration at n_side²
    points (the numeric base registered from the frozen data file)."""
    from gpe_tpu_torch.train.problem import GPESpec, make_batch

    sp = dict(cell.config["spec"])
    kw = tuple(sorted(sp.pop("potential_kwargs", {}).items()))
    if sp["basis"] == "numeric":
        from gpe_tpu_torch.physics.numeric import SineSeries2D, register_numeric_basis

        psi, xi, dx = base_data(cell.root, cell.config)
        sp["basis"] = register_numeric_basis(
            cell.config["name"], SineSeries2D(xi, psi, sp["lb"], sp["ub"]))
    spec = GPESpec(**{**sp, "layers": tuple(sp["layers"]), "potential_kwargs": kw,
                      "n_points": n_side})
    return spec, make_batch(spec, 0, device=cell.device)


# --------------------------------------------------------------------------
# the checks


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded in the process of a run."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def leaves(params) -> list:
    """The (W, b) pairs' tensors in order."""
    return [t for W, b in params for t in (W, b)]


def rel_gap(a: float, b: float) -> float:
    """|a − b| / |b|; inf where either is not finite."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-300)


def worst_leaf_gap(prog, ref, skip=()) -> float:
    """The largest |‖p_l‖ − ‖r_l‖| over leaves l, each against the larger
    of ‖r_l‖ and the median leaf's ‖r‖; leaves in `skip` are left out."""
    import torch

    pn = [float(torch.linalg.vector_norm(t.double())) for t in prog]
    rn = [float(torch.linalg.vector_norm(t.double())) for t in ref]
    med = sorted(rn)[len(rn) // 2]
    gaps = [abs(p - r) / max(r, med, 1e-300)
            for i, (p, r) in enumerate(zip(pn, rn)) if i not in skip]
    if not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def finite_answer(unit: dict) -> bool:
    """Whether a rung's or call's reported numbers are all finite."""
    vals = [unit.get("best_loss", 0.0), unit.get("mu_best", 0.0)] + unit.get("losses", [])
    return all(math.isfinite(v) for v in vals)


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, reading, limit)]): every reading finite and at or
    under its limit. A reading without a limit fails."""
    rows = [(k, v, limits.get(k)) for k, v in readings.items()]
    ok = all(lim is not None and math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
