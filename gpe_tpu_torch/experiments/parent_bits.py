"""The kernels that a change of K2's bf16 operand mode leaves alone, against
a parent checkout's build of the same sources, bit for bit.

    python -m gpe_tpu_torch.experiments.parent_bits --parent <checkout>/gpe_tpu_torch/csrc

Builds the parent's `fused_grad.cu`, `rowcat_eval.cu` and
`fused_residual.cu` (under `build/parent_bits/`; their C entry points must
be the port's) and runs each of these with the port's library, then with
the parent's, on chip_smoke.py's inputs:
- K1 (f32) and K2 at the main shape (gpe2d_ground_state: 50,176 points,
  [2,128,128,128,1], γ = 5, s = 0.05), K3 sums and K3 grads at
  harmonic_paper (six runs of [1,64,64,64,1] on 4,000 points); K2 and K3
  grads with the cotangents of the plain version's sums, so that K1's own
  sums do not enter: sums, and gradients with their sums;
- K4 (f32), K1-bf16 and K4-bf16 at the benchmark's shape (50,176 points,
  [2,100,100,100,1], γ = 5, s = 0.05): the sums.
(Against a parent from before a change to one of these kernels, that
kernel differs by design.)
Prints the card, then one JSON line: per kernel, whether every output
equals the parent's to the bit. Exits 1 if one does not. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from gpe_tpu_torch.bench import bench_spec, card_info
from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.experiments.configs import EXPERIMENTS
from gpe_tpu_torch.experiments.k2_variants import build, use, write_variant
from gpe_tpu_torch.kernels import _build
from gpe_tpu_torch.kernels import fused_grad as k2
from gpe_tpu_torch.kernels import fused_residual as k1
from gpe_tpu_torch.kernels import rowcat_eval as k4
from gpe_tpu_torch.models.mlp import init_mlp, stack_runs
from gpe_tpu_torch.train.problem import make_batch

# library name -> its wrapper module (for the entry points' bindings)
LIBS = {"fused_grad": k2, "rowcat_eval": k4, "fused_residual": k1}


def _phys(spec) -> dict:
    return dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
                nonlinearity=spec.nonlinearity)


def calls(dev) -> dict:
    """{kernel: (library name, call)} on chip_smoke.py's inputs."""
    seed = lambda s: torch.Generator().manual_seed(s)
    spec = EXPERIMENTS["gpe2d_ground_state"].spec
    batch = make_batch(spec, 0, device=dev)
    params = init_mlp(spec.layers, "xavier_uniform", generator=seed(0), device=dev)
    kw = _phys(spec)
    a = (params, batch["x"], batch["V"], batch["w"], 5.0, 0.05)
    base = (batch["base_val"], batch["base_lap"])
    n = batch["x"].shape[0]
    cots = k1.sums_to_loss(k1.collocation_sums_plain(*a, *base, **kw), n,
                           spec.norm_weight)[3]

    cfg = EXPERIMENTS["harmonic_paper"]
    rspec, modes = cfg.spec, cfg.modes
    R = len(modes)
    rb = make_batch(rspec, modes[0], device=dev)
    per = [make_batch(rspec, m, device=dev) for m in modes]
    rbase = tuple(torch.stack([b[k] for b in per]).contiguous()
                  for k in ("base_val", "base_lap"))
    rparams = stack_runs([init_mlp(rspec.layers, "xavier_uniform", generator=seed(100 + r),
                                   device=dev) for r in range(R)])
    rkw = _phys(rspec)
    ra = (rparams, rb["x"], rb["V"], rb["w"],
          torch.tensor([0.0, 0.5, 1.0, 2.0, 5.0, 10.0][:R], device=dev),
          torch.tensor([0.01 * (1 + r) for r in range(R)], device=dev))
    rcots = k1.sums_to_loss(k1.collocation_sums_runs_plain(*ra, *rbase, **rkw),
                            rb["x"].shape[0], rspec.norm_weight)[3]

    bspec = bench_spec()
    bb = make_batch(bspec, 0, device=dev)
    bparams = init_mlp(bspec.layers, "xavier_uniform", generator=seed(0), device=dev)
    ba = (bparams, bb["x"], bb["V"], bb["w"], 5.0, 0.05, bb.get("base_val"),
          bb.get("base_lap"))
    bkw = _phys(bspec)
    return {
        "K1": ("fused_residual", lambda: k1.collocation_sums(*a, *base, **kw)),
        "K3 sums": ("fused_residual",
                    lambda: k1.collocation_sums_runs(*ra, *rbase, **rkw)),
        "K2": ("fused_grad", lambda: k2.collocation_grads(*a, cots, *base, **kw)),
        "K3 grads": ("fused_grad",
                     lambda: k2.collocation_grads_runs(*ra, rcots, *rbase, **rkw)),
        "K4": ("rowcat_eval", lambda: k4.collocation_sums(*ba, **bkw)),
        "K1-bf16": ("fused_residual", lambda: k1.collocation_sums(
            *ba, **bkw, compute_dtype=torch.bfloat16)),
        "K4-bf16": ("rowcat_eval", lambda: k4.collocation_sums(
            *ba, **bkw, compute_dtype=torch.bfloat16)),
    }


def leaves(out) -> list:
    """The tensors of a kernel's output (a tensor or nested tuples)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in leaves(o)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the parent checkout's gpe_tpu_torch/csrc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("parent_bits needs a CUDA device")
    dev = torch.device("cuda", 0)
    pin_full_f32()
    name, limit = card_info(dev)
    print(f"{name}, {limit}", flush=True)
    root = _build.BUILD_ROOT.parent / "parent_bits"
    ours, theirs = {}, {}
    for lib, mod in LIBS.items():
        ours[lib] = _build.library(lib, mod._bind)
        write_variant(lib, [], root, args.parent)
        theirs[lib] = build({lib: root / lib}, f"{lib}.cu", mod._bind)[lib]
    equal = {}
    for kernel, (lib, fn) in calls(dev).items():
        use(ours[lib], lib)
        got = leaves(fn())
        use(theirs[lib], lib)
        want = leaves(fn())
        use(ours[lib], lib)
        equal[kernel] = len(got) == len(want) and all(
            torch.equal(g, w) for g, w in zip(got, want))
    print(json.dumps({"card": name, "power_limit": limit,
                      "bit_equal_to_parent": equal}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
