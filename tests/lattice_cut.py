"""The lattice continuation cut (gpe_tpu_torch/experiments/lattice_cut.py) in
both packages on the CPU, from the JAX package's initial params at `--seed`:
JAX's `train_plpinn` on the cut, then the port's from the same params.

    JAX_PLATFORMS=cpu python tests/lattice_cut.py [--package jax|torch|both]
        [--seed 0] [--n-points 24] [--width 32] [--depth 2] [--epochs 1500]
        [--dgamma 0.5] [--gmax 5] [--perturb 1e-7] [--save-init init.npz]
    JAX_PLATFORMS=cpu python tests/lattice_cut.py --lm-steps 300 --seeds 0 3 5
        [--save-lm-start start.npz]
    JAX_PLATFORMS=cpu python tests/lattice_cut.py --lm-steps 10 --seeds 0 3 5
        --lm-from tests/lattice_lm_start.npz

Prints one JSON line a package (its μ table and each rung's departure from
the first-order line, `lattice_cut.first_order_line`). `--perturb eps`
starts the port from JAX's weights times 1 + eps·N(0, 1) (numpy seed 123):
how far a tiny change of the start moves the departure. `--save-init` writes JAX's initial
params as the npz that `lattice_cut.py --init` reads on the card.
`--lm-steps N` runs JAX's cut to `--gmax` with its checkpoint LM polish
there (N steps, 80 CG iterations, as `gpe2d_lattice_plpinn`), then JAX's and the
port's `make_lm_solver` from the params, batch, γ and scale that LM was
given: one JSON line a seed (accepted steps, μ, loss and λ); with
`--save-lm-start` those starts go to an npz (tests/lattice_lm_start.npz,
what tests/test_torch_readings.py reads). With `--lm-from <npz>` the saved
starts are read instead, and each package's LM is also run on the same
start with its points reordered: the port's gap to JAX beside each
package's gap to itself under another summation order.
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


def cut_specs(n_points=24, width=32, depth=2):
    """(JAX's spec, the port's spec) of the cut: `gpe2d_lattice_plpinn`'s spec,
    field by field, at n_points² and [2, width × depth, 1], on the numeric
    base of the committed γ = 0 state registered in both packages."""
    import jax

    from gpe_tpu.physics import numeric as jnum
    from gpe_tpu.train import problem as jprob
    from gpe_tpu_torch.experiments import gpe2d_lattice_plpinn as tlp
    from gpe_tpu_torch.physics.numeric import register_numeric_basis
    jax.config.update("jax_platforms", "cpu")

    cache = np.load(os.path.join(CACHE_DIR, "oracle_cache.npz"))
    series, lb, ub = tlp.lattice_base(cache)
    name = jnum.register_numeric_basis(
        "lattice_gs", jnum.SineSeries2D(cache["xi"], cache["psis"][0], lb, ub))
    tspec = tlp.lattice_spec(register_numeric_basis("lattice_gs", series), lb, ub)
    assert tspec.basis == name
    layers = (2,) + (width,) * depth + (1,)
    kw = {f.name: getattr(tspec, f.name) for f in dataclasses.fields(tspec)
          if f.name != "dtype"}
    return (jprob.GPESpec(**dict(kw, n_points=n_points, layers=layers)),
            dataclasses.replace(tspec, n_points=n_points, layers=layers))


def jax_cut(seed=0, n_points=24, width=32, depth=2, epochs=1500, dgamma=0.5,
            gmax=5.0) -> dict:
    """The cut through the JAX package's `train_plpinn` on the CPU."""
    from gpe_tpu.train import plpinn as jpl
    from gpe_tpu_torch.experiments.lattice_cut import departure, first_order_line

    cache = np.load(os.path.join(CACHE_DIR, "oracle_cache.npz"))
    spec, _ = cut_specs(n_points, width, depth)
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


def accepted_steps(lams, lam0=1e-2, lam_min=1e-9) -> int:
    """LM steps accepted, read from λ's history: an accepted step halves λ
    (or keeps it at lam_min), a rejected one quadruples it."""
    lams = np.asarray(lams, np.float64)
    prev = np.concatenate([[lam0], lams[:-1]])
    # JAX keeps λ in float32, whose lam_min is 1e-9 to 7 digits
    floor = np.isclose(lams, lam_min, rtol=1e-6, atol=0)
    kept = floor & np.isclose(prev, lams, rtol=1e-6)
    return int(np.sum((lams < prev * (1 - 1e-6)) | kept))


def jax_lm_start(seed=0, n_points=24, width=32, depth=2, epochs=1500, dgamma=0.5,
                 gmax=5.0, lm_steps=300, cg_iters=80) -> dict:
    """JAX's cut to gmax with its checkpoint LM polish at gmax (the lattice
    script's polish, `polish_checkpoints`): what that LM was given — params,
    batch (the folded base of the rebased ramp), γ, scale — as numpy, and
    its loss and λ histories. The LM is seen through a wrapper of
    `gauss_newton.make_lm_solver` that is put back after the run."""
    import jax

    from gpe_tpu.train import gauss_newton as jgn
    from gpe_tpu.train import plpinn as jpl

    spec, _ = cut_specs(n_points, width, depth)
    ramp = [k * dgamma for k in range(int(round(gmax / dgamma)) + 1)]
    seen, make = {}, jgn.make_lm_solver

    def watched(residual_fn, template, **kw):
        solver = make(residual_fn, template, **kw)

        def run(params, batch, gamma, scale):
            res = solver(params, batch, gamma, scale)
            seen.update(
                params=[(np.asarray(w), np.asarray(b)) for w, b in params],
                batch={k: np.asarray(v) for k, v in batch.items()},
                gamma=float(gamma), scale=float(scale),
                losses=np.asarray(res.loss_history), lams=np.asarray(res.lam_history))
            return res
        return run

    jgn.make_lm_solver = watched
    try:
        res = jpl.train_plpinn(spec, ramp, modes=(0,), epochs=epochs, tol=0.0,
                               patience=10 ** 9, rebase=True, keep_params=False,
                               seed=seed, polish_checkpoints=(gmax,),
                               lm_steps=lm_steps, lm_cg_iters=cg_iters)
    finally:
        jgn.make_lm_solver = make
    jax.clear_caches()
    return dict(seen, seed=seed, mu_polished=float(res.polished[0]["by_gamma"][gmax]),
                mu_table=[(float(g), float(m)) for g, m in res.mu_table[0]])


def save_lm_start(path, starts) -> None:
    """The LM starts of several seeds in one npz (keys "<seed>/<name>")."""
    out = {}
    for st in starts:
        pre = f"{st['seed']}/"
        for i, (w, b) in enumerate(st["params"]):
            out[f"{pre}w{i}"], out[f"{pre}b{i}"] = w, b
        out.update({f"{pre}batch/{k}": v for k, v in st["batch"].items()})
        for k in ("gamma", "scale", "losses", "lams", "mu_polished"):
            out[pre + k] = np.asarray(st[k])
    np.savez_compressed(path, **out)


def load_lm_start(path, seed) -> dict:
    """One seed's LM start written by `save_lm_start`."""
    pre = f"{seed}/"
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith(pre + "w"))
        return {"seed": seed,
                "params": [(z[f"{pre}w{i}"], z[f"{pre}b{i}"]) for i in range(n)],
                "batch": {k[len(pre + "batch/"):]: z[k] for k in z.files
                          if k.startswith(pre + "batch/")},
                **{k: z[pre + k] for k in ("losses", "lams")},
                **{k: float(z[pre + k]) for k in ("gamma", "scale", "mu_polished")}}


def lm_both(start, n_points=24, width=32, depth=2, lm_steps=300, cg_iters=80) -> dict:
    """JAX's `make_lm_solver` and the port's from the same start (params,
    batch, γ, scale) on the CPU in float32: each one's loss and λ
    histories, accepted steps and μ after it (each package's loss_fn)."""
    import jax.numpy as jnp
    import torch

    from gpe_tpu.train import gauss_newton as jgn
    from gpe_tpu.train.problem import make_loss_fn as jloss
    from gpe_tpu_torch.models.mlp import params_from_numpy
    from gpe_tpu_torch.train import gauss_newton as tgn
    from gpe_tpu_torch.train.problem import make_loss_fn as tloss

    jspec, tspec = cut_specs(n_points, width, depth)
    g, s = start["gamma"], start["scale"]
    jp = [(jnp.asarray(w), jnp.asarray(b)) for w, b in start["params"]]
    jb = {k: jnp.asarray(v) for k, v in start["batch"].items()}
    jres = jgn.make_lm_solver(jgn.make_gpe_residual_fn(jspec), jp, steps=lm_steps,
                              cg_iters=cg_iters)(jp, jb, jnp.float32(g), jnp.float32(s))
    jmu = float(jloss(jspec)(jres.params, jb, jnp.float32(g), jnp.float32(s))[1]["mu"])
    tp = params_from_numpy(start["params"], device="cpu")
    tb = {k: torch.as_tensor(np.array(v)) for k, v in start["batch"].items()}
    tres = tgn.make_lm_solver(tgn.make_gpe_residual_fn(tspec), tp, steps=lm_steps,
                              cg_iters=cg_iters)(tp, tb, g, s)
    with torch.no_grad():
        tmu = float(tloss(tspec)(tres.params, tb, g, s)[1]["mu"])
    out = {}
    for pkg, res, mu in (("jax", jres, jmu), ("torch", tres, tmu)):
        losses = np.asarray(res.loss_history, np.float64)
        lams = np.asarray(res.lam_history, np.float64)
        out[pkg] = {"accepted": accepted_steps(lams), "mu": mu,
                    "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
                    "lam_last": float(lams[-1]), "losses": losses, "lams": lams}
    return out


BOUNDARY_KEYS = ("bx", "base_bval")


def reordered(start, seed=0) -> dict:
    """The same LM start with its collocation points and its boundary
    points each in another order (numpy seed `seed`): the same problem
    summed in other orders, the spread a sound route may show."""
    rng = np.random.default_rng(seed)
    b = start["batch"]
    p = rng.permutation(len(b["x"]))
    q = rng.permutation(len(b["bx"]))
    return dict(start, batch={k: v[q] if k in BOUNDARY_KEYS else v[p]
                              for k, v in b.items()})


def lm_gap(both) -> dict:
    """Where the two packages' LM runs part: the first step whose λ
    differs (None: never), and the largest relative loss gap before it and
    over the whole run."""
    jl, tl = both["jax"]["lams"], both["torch"]["lams"]
    part = np.flatnonzero(~np.isclose(tl, jl, rtol=1e-6, atol=0))
    n = int(part[0]) if part.size else len(jl)
    gap = np.abs(both["torch"]["losses"] - both["jax"]["losses"]) / both["jax"]["losses"]
    return {"lams_part_at": n if part.size else None,
            "max_rel_loss_gap_before": float(gap[:n].max()) if n else 0.0,
            "max_rel_loss_gap": float(gap.max())}


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
    ap.add_argument("--lm-steps", type=int, default=0,
                    help="instead of the cut's μ tables: JAX's cut to --gmax with its "
                         "checkpoint LM there, then both packages' LM from what JAX's "
                         "LM was given (accepted steps, μ, losses)")
    ap.add_argument("--seeds", type=int, nargs="+", help="with --lm-steps: several seeds")
    ap.add_argument("--save-lm-start", help="with --lm-steps: write the LM starts (npz)")
    ap.add_argument("--lm-from", help="with --lm-steps: read the LM starts from this npz "
                                      "(no cut); each seed also on reordered points")
    args = ap.parse_args(argv)
    if args.lm_steps and args.lm_from:
        for seed in args.seeds or [args.seed]:
            st = load_lm_start(args.lm_from, seed)
            runs = {"": lm_both(st, args.n_points, args.width, args.depth, args.lm_steps),
                    "reordered": lm_both(reordered(st), args.n_points, args.width,
                                         args.depth, args.lm_steps)}
            pairs = {"torch_vs_jax": (runs[""]["torch"], runs[""]["jax"]),
                     "jax_reordered_vs_jax": (runs["reordered"]["jax"], runs[""]["jax"]),
                     "torch_reordered_vs_torch": (runs["reordered"]["torch"],
                                                  runs[""]["torch"])}
            print(json.dumps({"seed": seed, "steps": args.lm_steps, **{
                name: {"accepted": [a["accepted"], b["accepted"]],
                       "mu_gap": abs(a["mu"] - b["mu"]),
                       **lm_gap({"torch": a, "jax": b})}
                for name, (a, b) in pairs.items()}}), flush=True)
        return 0
    if args.lm_steps:
        starts = []
        for seed in args.seeds or [args.seed]:
            st = jax_lm_start(seed, args.n_points, args.width, args.depth, args.epochs,
                              args.dgamma, args.gmax, args.lm_steps)
            starts.append(st)
            both = lm_both(st, args.n_points, args.width, args.depth, args.lm_steps)
            print(json.dumps({
                "seed": seed, "gamma": st["gamma"], "scale": st["scale"],
                "mu_table": st["mu_table"], "in_run": {
                    "accepted": accepted_steps(st["lams"]), "mu": st["mu_polished"]},
                **{pkg: {k: v for k, v in r.items() if k not in ("losses", "lams")}
                   for pkg, r in both.items()},
                **lm_gap(both)}), flush=True)
        if args.save_lm_start:
            save_lm_start(args.save_lm_start, starts)
        return 0
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
