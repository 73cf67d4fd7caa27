"""The bf16 operand modes' design choices, measured: compile-time variants of
`csrc/fused_residual.cu` (K1-bf16) and `csrc/rowcat_eval.cu` (K4-bf16),
with `csrc/common.cuh` (their shared bf16 tensor-core GEMM), each the
sources with a few lines replaced, built beside the port's libraries (under
`build/bf16_variants/`, not committed) and timed on the card in place of the
real kernels. The helpers are k2_variants.py's.

    python -m gpe_tpu_torch.experiments.bf16_variants [--clocks] [--parent DIR]
        [VARIANT ...]

Variants:
- as_is: the sources unchanged (hidden GEMMs on bf16 tensor cores,
  mma.sync m16n8k16 with f32 accumulators);
- ffma: both kernels' bf16 hidden GEMMs back on FFMA (K1: gemm_tile, its
  resident weights rounded as they are staged; K4: k4_variants.py's ffma
  patch, the FFMA loop, run on the bf16 operands), the arithmetic before
  the redesign;
- rounded_staging: K1-bf16's resident weights rounded to bf16 by the
  synchronous loop load_w<true> instead of copied by cp.async as f32 and
  rounded as the GEMM packs them (the same bits);
- split_tail: the bf16 GEMM's full k16 slabs unguarded and the last
  partial one (contraction not a multiple of 16) guarded in a copy of the
  loop body, instead of a guard on every slab (the same bits);
- no_operand_loads: the GEMM's fragments made from the slab index instead
  of loaded from shared memory and packed (wrong by design, timed only):
  what the operand loads cost.

--parent DIR adds the variant "parent": the unpatched sources in DIR (a
checkout's gpe_tpu_torch/csrc with the same C entry points), timed in turns
with the others (name only `parent` to time it alone). --clocks also builds
as_is and the parent, where they are timed, with clock64 marks after the
phase barriers and prints the cycles per phase of K1-bf16 and K4-bf16
(thread 0, summed over a launch, mean over the blocks that ran).

For each variant: K1-bf16 and K4-bf16 at the benchmark's shape (50,176
points, [2,100,100,100,1]) and at the main shape (gpe2d_ground_state: 50,176
points, [2,128,128,128,1]), γ = 5, s = 0.05, timed in turns over the
variants (forward then reverse order, twice) two ways with CUDA events: "ms",
the replays of a CUDA graph of one call (device time), and "call ms",
back-to-back calls (host work included); their largest relative error per
sum against the bf16 plain version there and on the card tests' nets at
weights x1 and x4. First, for the port's own build, the registers, local
memory (spills), tensor-core (HMMA) and FFMA instructions of each kernel in
its SASS (`cuobjdump`). One JSON line per variant. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from gpe_tpu_torch.bench import bench_spec, card_info, graph_ms, time_ms
from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.experiments.configs import EXPERIMENTS
from gpe_tpu_torch.experiments.k1_variants import CLOCK_PATCH as K1_CLOCK_PATCH
from gpe_tpu_torch.experiments.k1_variants import PHASES as K1_PHASES
from gpe_tpu_torch.experiments.k1_variants import _rel, _scaled_inputs
from gpe_tpu_torch.experiments.k2_variants import build, clocks, use, write_variant
from gpe_tpu_torch.experiments.k4_variants import CLOCK_PATCH as K4_CLOCK_PATCH
from gpe_tpu_torch.experiments.k4_variants import PATCHES as K4_PATCHES
from gpe_tpu_torch.experiments.k4_variants import PHASES as K4_PHASES
from gpe_tpu_torch.experiments.k4_variants import sass_report
from gpe_tpu_torch.kernels import _build
from gpe_tpu_torch.kernels import fused_residual as k1
from gpe_tpu_torch.kernels import rowcat_eval as k4
from gpe_tpu_torch.models.mlp import init_mlp
from gpe_tpu_torch.train.problem import make_batch

K1 = "fused_residual.cu"
K4 = "rowcat_eval.cu"
CMN = "common.cuh"
_STAGE = ("prm_r + net.w_off[l], net.dims[l], net.dims[l + 1], Wsm + (l - 1) * TILE);\n")
# mma_gemm_bf16's k16 slab loop, in pieces
_LOOP = "  for (int q0 = 0; q0 < P; q0 += 16) {\n    const int k = q0 + 2 * t;\n"
_GUARDS = "    const bool in0 = k < P, in1 = k + 1 < P, in8 = k + 8 < P, in9 = k + 9 < P;\n"
_A_FRAGS = ("      const float* p = aq + 16 * mt;\n"
            "      af[mt][0] = pack_bf16(in0 ? p[0] : 0.f, in1 ? p[LDS] : 0.f);\n"
            "      af[mt][1] = pack_bf16(in0 ? p[8] : 0.f, in1 ? p[LDS + 8] : 0.f);\n"
            "      af[mt][2] = pack_bf16(in8 ? p[8 * LDS] : 0.f, in9 ? p[9 * LDS] : 0.f);\n"
            "      af[mt][3] = pack_bf16(in8 ? p[8 * LDS + 8] : 0.f, in9 ? p[9 * LDS + 8] : 0.f);\n")
_B_FRAGS = ("      const float* p = bq + 8 * nt;\n"
            "      bf[nt][0] = pack_bf16(in0 ? p[0] : 0.f, in1 ? p[LDB] : 0.f);\n"
            "      bf[nt][1] = pack_bf16(in8 ? p[8 * LDB] : 0.f, in9 ? p[9 * LDB] : 0.f);\n")
_BODY = ("    const float* aq = a + q0 * LDS;\n    const float* bq = b + q0 * LDB;\n"
         "    uint32_t af[MT][4], bf[NTL][2];\n#pragma unroll\n"
         "    for (int mt = 0; mt < MT; ++mt) {\n" + _A_FRAGS + "    }\n#pragma unroll\n"
         "    for (int nt = 0; nt < NTL; ++nt) {\n" + _B_FRAGS + "    }\n#pragma unroll\n"
         "    for (int mt = 0; mt < MT; ++mt)\n#pragma unroll\n"
         "      for (int nt = 0; nt < NTL; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);\n  }\n")
# name -> [(file, text, replacement[, occurrences, default 1])]
PATCHES = {
    "ffma_k1": [     # with round_staged, which gives load_w its rounding
        (K1, "forward_tile<D, BF16, true, WROWS>(", "forward_tile<D, BF16, !BF16, WROWS>("),
        (CMN, "      load_w(prm + net.w_off[l], K, N, Wl);",
         "      load_w<BF16>(prm + net.w_off[l], K, N, Wl);"),
    ],
    "ffma_k4": K4_PATCHES["ffma"] + K4_PATCHES["stride4"] + [   # gemm_inplace<false>
        (K4, "      gemm_inplace<BF16>(", "      gemm_inplace<false>("),   # made FFMA, both modes
    ],
    "round_staged": [
        (CMN, "__device__ __forceinline__ void load_w(",
         "template <bool BF16 = false>\n__device__ __forceinline__ void load_w("),
        (CMN, "    dst[k * LDS + o] = (o < N) ? W[k * N + o] : 0.f;",
         "    dst[k * LDS + o] = (o < N) ? op<BF16>(W[k * N + o]) : 0.f;"),
        (K1, "        stage_w(" + _STAGE,
         "        if constexpr (BF16) load_w<true>(" + _STAGE + "        else stage_w(" + _STAGE),
    ],
    "split_tail": [
        (CMN, _LOOP + _GUARDS + _BODY,
         "  int q0 = 0;\n  for (; q0 + 16 <= P; q0 += 16) {\n    const int k = q0 + 2 * t;\n"
         "    const bool in0 = true, in1 = true, in8 = true, in9 = true;\n" + _BODY
         + "  if (q0 < P) {\n    const int k = q0 + 2 * t;\n" + _GUARDS + _BODY),
    ],
    "no_loads": [
        (CMN, _A_FRAGS, "      const float p = 1e-3f * (k + 16 * mt);\n"
                        "      af[mt][0] = pack_bf16(in0 ? p : 0.f, in1 ? p + 1.f : 0.f);\n"
                        "      af[mt][1] = pack_bf16(in0 ? p + 2.f : 0.f, in1 ? p + 3.f : 0.f);\n"
                        "      af[mt][2] = pack_bf16(in8 ? p + 4.f : 0.f, in9 ? p + 5.f : 0.f);\n"
                        "      af[mt][3] = pack_bf16(in8 ? p + 6.f : 0.f, in9 ? p + 7.f : 0.f);\n"),
        (CMN, _B_FRAGS, "      const float p = 1e-3f * (k + 8 * nt);\n"
                        "      bf[nt][0] = pack_bf16(in0 ? p : 0.f, in1 ? p + 1.f : 0.f);\n"
                        "      bf[nt][1] = pack_bf16(in8 ? p + 2.f : 0.f, in9 ? p + 3.f : 0.f);\n"),
    ],
}
# name -> (patches, computes the sums)
VARIANTS = {
    "as_is": ((), True),
    "ffma": (("ffma_k1", "round_staged", "ffma_k4"), True),
    "rounded_staging": (("round_staged",), True),
    "split_tail": (("split_tail",), True),
    "no_operand_loads": (("no_loads",), False),
}

# K1's clock marks and k4_variants.py's (K1's declare the counters)
CLOCK_PATCH = K1_CLOCK_PATCH + K4_CLOCK_PATCH
SOURCES = {"fused_residual": (K1, k1), "rowcat_eval": (K4, k4)}


def patches_of(variant: str) -> list:
    """The patch list of `variant`, or of `<variant>+clocks` ("parent+clocks":
    the clock marks alone, on the parent's sources)."""
    name, _, clocked = variant.partition("+")
    own = [] if name == "parent" else [x for p in VARIANTS[name][0] for x in PATCHES[p]]
    return own + (CLOCK_PATCH if clocked else [])


def cases(dev):
    """[(label, library name, kernel call, plain call)]: K1-bf16 and K4-bf16
    at the benchmark's and the main shape (timed), then on the card tests'
    nets at weights x1 and x4."""
    bf16 = torch.bfloat16
    out = []
    for shape, spec in (("bench", bench_spec()),
                        ("main", EXPERIMENTS["gpe2d_ground_state"].spec)):
        batch = make_batch(spec, 0, device=dev)
        params = init_mlp(spec.layers, "xavier_uniform",
                          generator=torch.Generator().manual_seed(0), device=dev)
        a = (params, batch["x"], batch["V"], batch["w"], 5.0, 0.05,
             batch.get("base_val"), batch.get("base_lap"))
        kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
                  nonlinearity=spec.nonlinearity, compute_dtype=bf16)
        for lib, (_, mod) in SOURCES.items():
            out.append((f"{'K1' if mod is k1 else 'K4'}-bf16 {shape}", lib,
                        lambda mod=mod, a=a, kw=kw: mod.collocation_sums(*a, **kw),
                        lambda mod=mod, a=a, kw=kw: mod.collocation_sums_plain(*a, **kw)))
    phys = ("shifted_tanh", 3.0, 0.5, "abs_power")
    for layers, n in (((2, 100, 100, 100, 1), 3000), ((1, 48, 40, 40, 40, 1), 777)):
        for w_scale in (1.0, 4.0):
            xa = _scaled_inputs(layers, n, w_scale, dev)
            xa = (*xa[:4], 5.0, 0.05, *xa[4:], *phys)
            for lib, (_, mod) in SOURCES.items():
                out.append((f"{'K1' if mod is k1 else 'K4'}-bf16 {list(layers)} "
                            f"weights x{w_scale:g}", lib,
                            lambda mod=mod, xa=xa: mod.collocation_sums(
                                *xa, compute_dtype=torch.bfloat16),
                            lambda mod=mod, xa=xa: mod.collocation_sums_plain(
                                *xa, compute_dtype=torch.bfloat16)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="VARIANT",
                    help=f"any of {', '.join(VARIANTS)}, or parent (default: all, and "
                         "parent with --parent)")
    ap.add_argument("--clocks", action="store_true",
                    help="also the per-phase cycles of as_is and the parent, if timed")
    ap.add_argument("--parent", type=Path, default=None,
                    help="the unpatched sources of the variant parent")
    args = ap.parse_args(argv)
    args.variants = args.variants or list(VARIANTS) + ["parent"] * bool(args.parent)
    unknown = sorted(set(args.variants) - set(VARIANTS) - ({"parent"} if args.parent
                                                            else set()))
    if unknown:
        ap.error(f"unknown variants {unknown} (parent needs --parent)")
    if not torch.cuda.is_available():
        raise SystemExit("bf16_variants needs a CUDA device")
    dev = torch.device("cuda", 0)
    pin_full_f32()
    name, limit = card_info(dev)
    print(f"{name}, {limit}", flush=True)
    for lib in SOURCES:                          # the port's own build
        print(json.dumps({"sass": lib, "kernels": sass_report(
            _build.build_all() / f"lib{lib}.so")}), flush=True)
    root = _build.BUILD_ROOT.parent / "bf16_variants"
    clocked = [v for v in ("as_is", "parent") if args.clocks and v in args.variants]
    names = list(args.variants) + [v + "+clocks" for v in clocked]
    for v in names:
        write_variant(v, patches_of(v), root, args.parent if v.startswith("parent")
                      else None)
    dirs = {v: root / v for v in names}
    t0 = time.perf_counter()
    libs = {lib: build(dirs, src, mod._bind) for lib, (src, mod) in SOURCES.items()}
    print(f"{len(dirs) * len(SOURCES)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)

    work = cases(dev)
    wants = [plain() for _, _, _, plain in work]
    res = {v: {"variant": v, "card": name, "power_limit": limit} for v in args.variants}
    for v in args.variants:
        if v != "parent" and not VARIANTS[v][1]:
            continue
        for (label, lib, fn, _), want in zip(work, wants):
            use(libs[lib][v], lib)
            res[v][f"rel {label}"] = _rel(fn(), want)
    order = list(args.variants) + list(reversed(args.variants))
    for _ in range(2):
        for v in order:
            for label, lib, fn, _ in work[:4]:
                use(libs[lib][v], lib)
                res[v].setdefault(f"{label} ms", []).append(graph_ms(fn, 30, dev))
                res[v].setdefault(f"{label} call ms", []).append(time_ms(fn, 30, dev))
    for v in clocked:
        res[v]["clocks"] = {label: clocks(
            libs[lib][v + "+clocks"], fn, name=lib, blocks=512,
            entry="gpe_k1_clocks" if lib == "fused_residual" else "gpe_k4_clocks",
            phases=K1_PHASES if lib == "fused_residual" else K4_PHASES)
            for label, lib, fn, _ in work[:4]}
    for r in res.values():
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
