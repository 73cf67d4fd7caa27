"""The lattice continuation of `gpe2d_lattice_plpinn` at a cut size, to see
whether the rebased γ ramp leaves the first-order line μ₀ + γ·∫|ψ₀|^(p+1)
that the frozen γ = 0 state gives (`first_order_line`), on one route at a
time.

The cut is the driver's `train_plpinn` call (rebase=True, keep_params=False,
tol 0, no polish, the default pretraining and check interval) on the
committed cache's γ = 0 base with `n_points`² points and a net of `depth`
hidden layers of `width`. The net starts from the params in `--init` (an
npz of w0, b0, w1, b1, …: the JAX package's initial params, so both
packages start alike) or from the port's own init at `--seed`. The route: `fused` (the driver's: relaxed K2), `exact` (the
exact K2 step, K1 every step), `autograd`; the CPU takes autograd whatever
is asked, as `make_fused_value_and_grad` declines there.

    python -m gpe_tpu_torch.experiments.lattice_cut [--init init.npz] [--seed 0]
        [--n-points 24] [--width 32] [--depth 2] [--epochs 1500] [--dgamma 0.5]
        [--gmax 5] [--route fused|exact|autograd] [--dir runs/gpe2d_lattice] [--cpu]

Prints one JSON line: the μ table, the line (μ₀, slope) and each rung's
distance from it (`departure`), seconds a rung, K1/K2 launches
and the device. Writes nothing; runs on the CUDA card unless `--cpu` is
given.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from unittest import mock

ROUTES = {"fused": {}, "exact": {"GPE_TPU_TORCH_NO_RELAXED": "1"},
          "autograd": {"GPE_TPU_TORCH_NO_FUSED": "1"}}


def _route_env(route: str):
    """The environment with the switches of `route` (ROUTES) set and the
    other route's cleared, the caller's restored after."""
    switches = {k for env in ROUTES.values() for k in env}
    env = {k: v for k, v in os.environ.items() if k not in switches}
    return mock.patch.dict(os.environ, dict(env, **ROUTES[route]), clear=True)


def _carried_init(init):
    """train_plpinn's `mlp.init_mlp` returning `init` (numpy (W, b) pairs)
    on the device it is asked for; the port's own init when init is None."""
    from gpe_tpu_torch.models import mlp

    if init is None:
        return contextlib.nullcontext()
    return mock.patch.object(mlp, "init_mlp", lambda *a, device=None, **kw:
                             mlp.params_from_numpy(init, device=device))


def first_order_line(cache) -> tuple:
    """(μ₀, slope) of the first-order line μ₀ + γ·∫|ψ₀|^(p+1) that the frozen
    γ = 0 state follows: the cache's γ = 0 oracle μ and state (p = 3, the
    driver's abs_power)."""
    import numpy as np

    psi, dx = np.asarray(cache["psis"][0]), float(cache["dx"])
    a2 = np.abs(psi) ** 2
    norm = np.sum(a2) * dx * dx
    return float(cache["mu_refs"][0]), float(np.sum(a2 * a2) * dx * dx / norm ** 2)


def departure(mu_table, line) -> list:
    """μ − the first-order line at each rung (negative: below the line)."""
    m0, s = line
    return [m - (m0 + s * g) for g, m in mu_table]


def run_cut(init=None, seed: int = 0, n_points: int = 24, width: int = 32,
            depth: int = 2, epochs: int = 1500, dgamma: float = 0.5,
            gmax: float = 5.0, route: str = "fused", cache_dir: str = "runs/gpe2d_lattice",
            device=None) -> dict:
    """The cut on `device` (None → the CUDA card): μ table, departure, seconds
    a rung, launches."""
    import dataclasses

    import numpy as np
    import torch

    from gpe_tpu_torch.device import resolve_device
    from gpe_tpu_torch.experiments import gpe2d_lattice_plpinn as lp
    from gpe_tpu_torch.kernels._common import LaunchCounter
    from gpe_tpu_torch.physics.numeric import register_numeric_basis
    from gpe_tpu_torch.train.plpinn import train_plpinn

    dev = resolve_device(device)
    cache = np.load(os.path.join(cache_dir, "oracle_cache.npz"))
    series, lb, ub = lp.lattice_base(cache)
    spec = lp.lattice_spec(register_numeric_basis("lattice_gs", series), lb, ub)
    spec = dataclasses.replace(spec, n_points=n_points,
                               layers=(2,) + (width,) * depth + (1,))
    ramp = [k * dgamma for k in range(int(round(gmax / dgamma)) + 1)]
    launches = LaunchCounter()
    t0 = time.perf_counter()
    with _route_env(route), _carried_init(init):
        res = train_plpinn(spec, ramp, modes=(0,), epochs=epochs, tol=0.0,
                           patience=10 ** 9, rebase=True, keep_params=False,
                           seed=seed, device=dev)
    table = [(float(g), float(m)) for g, m in res.mu_table[0]]
    line = first_order_line(cache)
    return {"route": route if dev.type == "cuda" else "autograd (cpu)",
            "seed": seed, "n_points": n_points, "layers": list(spec.layers),
            "epochs": epochs, "dgamma": dgamma, "mu_table": table,
            "line": line, "departure": departure(table, line),
            "seconds_per_rung": [float(s) for s in res.seconds["fit"][0].values()],
            "wall_s": time.perf_counter() - t0, "launches": launches.since(),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def load_init(path: str) -> list:
    """(W, b) pairs from an npz of w0, b0, w1, b1, …"""
    import numpy as np

    with np.load(path) as z:
        n = len(z.files) // 2
        return [(z[f"w{i}"], z[f"b{i}"]) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", help="npz of the initial params (w0, b0, …)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-points", type=int, default=24)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--dgamma", type=float, default=0.5)
    ap.add_argument("--gmax", type=float, default=5.0)
    ap.add_argument("--route", choices=sorted(ROUTES), default="fused")
    ap.add_argument("--dir", default="runs/gpe2d_lattice", help="read: oracle_cache.npz")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    out = run_cut(load_init(args.init) if args.init else None, args.seed,
                  args.n_points, args.width, args.depth, args.epochs, args.dgamma,
                  args.gmax, args.route,
                  args.dir, "cpu" if args.cpu else None)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
