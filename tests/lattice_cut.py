"""The lattice continuation cut (gpe_tpu_torch/experiments/lattice_cut.py) in
both packages on the CPU, from the JAX package's initial params at `--seed`:
JAX's `train_plpinn` on the cut, then the port's from the same params.

    JAX_PLATFORMS=cpu python tests/lattice_cut.py [--package jax|torch|both]
        [--seed 0] [--n-points 24] [--width 32] [--depth 2] [--epochs 1500]
        [--dgamma 0.5] [--gmax 5] [--perturb 1e-7] [--save-init init.npz]

Prints one JSON line a package (its μ table and each rung's departure from
the first-order line, `lattice_cut.first_order_line`). `--perturb eps`
starts the port from JAX's weights times 1 + eps·N(0, 1) (numpy seed 123):
how far a tiny change of the start moves the departure. `--save-init` writes JAX's initial
params as the npz that `lattice_cut.py --init` reads on the card.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

CACHE_DIR = "runs/gpe2d_lattice"


def jax_init(seed: int, layers) -> list:
    """JAX's `train_plpinn` initial params of mode 0 at `seed`, as numpy."""
    import jax

    from gpe_tpu.models import mlp as jmlp
    jax.config.update("jax_platforms", "cpu")
    return [(np.asarray(w), np.asarray(b)) for w, b in
            jmlp.init_mlp(jax.random.PRNGKey(seed), tuple(layers), "xavier_uniform")]


def jax_cut(seed=0, n_points=24, width=32, depth=2, epochs=1500, dgamma=0.5,
            gmax=5.0) -> dict:
    """The cut through the JAX package's `train_plpinn` on the CPU."""
    import jax

    from gpe_tpu.physics import numeric as jnum
    from gpe_tpu.train import plpinn as jpl
    from gpe_tpu.train import problem as jprob
    from gpe_tpu_torch.experiments import gpe2d_lattice_plpinn as tlp
    from gpe_tpu_torch.experiments.lattice_cut import departure, first_order_line
    jax.config.update("jax_platforms", "cpu")

    cache = np.load(os.path.join(CACHE_DIR, "oracle_cache.npz"))
    _, lb, ub = tlp.lattice_base(cache)
    name = jnum.register_numeric_basis(
        "lattice_gs", jnum.SineSeries2D(cache["xi"], cache["psis"][0], lb, ub))
    tspec = tlp.lattice_spec(name, lb, ub)      # the driver's spec, field by field
    kw = {f.name: getattr(tspec, f.name) for f in dataclasses.fields(tspec)
          if f.name != "dtype"}
    spec = jprob.GPESpec(**dict(kw, n_points=n_points,
                                layers=(2,) + (width,) * depth + (1,)))
    ramp = [k * dgamma for k in range(int(round(gmax / dgamma)) + 1)]
    t0 = time.perf_counter()
    res = jpl.train_plpinn(spec, ramp, modes=(0,), epochs=epochs, tol=0.0,
                           patience=10 ** 9, rebase=True, keep_params=False,
                           seed=seed)
    table = [(float(g), float(m)) for g, m in res.mu_table[0]]
    line = first_order_line(cache)
    return {"package": "jax", "seed": seed, "n_points": n_points,
            "layers": list(spec.layers), "epochs": epochs, "dgamma": dgamma,
            "mu_table": table, "line": line, "departure": departure(table, line),
            "wall_s": time.perf_counter() - t0}


def torch_cut(seed=0, n_points=24, width=32, depth=2, epochs=1500, dgamma=0.5,
              gmax=5.0, perturb=0.0) -> dict:
    """The cut through the port on the CPU, from JAX's initial params (the
    weights times 1 + perturb·N(0, 1) when perturb is not 0)."""
    from gpe_tpu_torch.experiments.lattice_cut import run_cut

    init = jax_init(seed, (2,) + (width,) * depth + (1,))
    if perturb:
        rng = np.random.default_rng(123)
        init = [(w * (1 + perturb * rng.standard_normal(w.shape)).astype(w.dtype), b)
                for w, b in init]
    out = run_cut(init, seed, n_points, width, depth, epochs, dgamma, gmax,
                  cache_dir=CACHE_DIR, device="cpu")
    return dict(out, package="torch", perturb=perturb)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch", "both"), default="both")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-points", type=int, default=24)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--dgamma", type=float, default=0.5)
    ap.add_argument("--gmax", type=float, default=5.0)
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="the port's start: JAX's weights times 1 + this·N(0, 1)")
    ap.add_argument("--save-init", help="write JAX's initial params here (npz)")
    args = ap.parse_args(argv)
    kw = dict(seed=args.seed, n_points=args.n_points, width=args.width,
              depth=args.depth, epochs=args.epochs, dgamma=args.dgamma,
              gmax=args.gmax)
    if args.save_init:
        init = jax_init(args.seed, (2,) + (args.width,) * args.depth + (1,))
        np.savez(args.save_init, **{f"{k}{i}": a for i, (w, b) in enumerate(init)
                                    for k, a in (("w", w), ("b", b))})
    for pkg in (("jax", "torch") if args.package == "both" else (args.package,)):
        out = jax_cut(**kw) if pkg == "jax" else torch_cut(**kw, perturb=args.perturb)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    raise SystemExit(main())
