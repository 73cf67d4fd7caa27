"""K4 f32's design choices, measured: compile-time variants of
`csrc/rowcat_eval.cu` with `csrc/common.cuh` (its 3xTF32 GEMM routine,
shared with K1 and K2), each the sources with a few lines replaced, built
beside the port's libraries (under `build/k4_variants/`, not committed) and
timed on the card in place of the real kernel. The helpers are
k2_variants.py's.

    python -m gpe_tpu_torch.experiments.k4_variants [--clocks] [--parent DIR]
        [VARIANT ...]

Variants:
- as_is: the sources unchanged (f32 hidden GEMMs in 3xTF32, mma.sync
  m16n8k8 on 64 x 64 warp blocks of the 128 x 256 output, row strides
  ≡ 8 mod 32 floats);
- ffma: the f32 hidden GEMMs on the FFMA loop the kernel had before (an
  8 x 16 register tile a thread, float4 operand loads), carried here as
  patch text, at that kernel's strides (stride4's);
- tf32x1: one TF32 product per f32 product (hi·hi′ only), the error that
  the split removes;
- stride4: the f32 mode's row strides ≡ 4 (mod 32) floats, the bf16
  mode's, 260 for the state and 132 for the weight tile, where the TF32
  fragment loads (row t, column g) fall on banks 4t + g, two ways on 12 of
  the 20 banks (at ≡ 8, banks 8t + g, conflict-free). The same arithmetic,
  so the same bits.

--parent DIR adds the variant "parent": the unpatched sources in DIR (a
checkout's gpe_tpu_torch/csrc with the same C entry points), timed in turns
with the others (name only `parent` to time it alone). For as_is and the
parent, K1 f32 (both shapes), K3 sums and K2 are built from the same
sources and timed too: K4 against K1, and the shared GEMM routine's other
callers against the parent. --clocks also builds as_is and the parent,
where they are timed, with clock64 marks after K4's phase barriers and
prints its cycles per phase (thread 0, summed over a launch, mean over the
blocks that ran).

For each variant: K4 f32 at the benchmark's shape (50,176 points,
[2,100,100,100,1]) and at the main shape (gpe2d_ground_state: 50,176 points,
[2,128,128,128,1]), γ = 5, s = 0.05, timed in turns over the variants
(forward then reverse order, twice) two ways with CUDA events: "ms", the
replays of a CUDA graph of one call (device time), and "call ms",
back-to-back calls (host work included); its largest relative error per
sum against the plain version there and on the card tests' nets at weights
x1 and x4. First, ptxas's registers and spills of each `k4_kernel` in the
port's own build, then for each variant's build the registers, local memory
(spills), tensor-core (HMMA) and FFMA instructions of each `k4_kernel` in
its SASS (`cuobjdump`). One JSON line per variant. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from pathlib import Path

import torch

from gpe_tpu_torch.bench import bench_spec, card_info, graph_ms, time_ms
from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.experiments.configs import EXPERIMENTS
from gpe_tpu_torch.experiments.k1_variants import CLOCK_PATCH as K1_CLOCK_PATCH
from gpe_tpu_torch.experiments.k1_variants import _rel, _scaled_inputs
from gpe_tpu_torch.experiments.k1_variants import cases as k1_cases
from gpe_tpu_torch.experiments.k2_variants import PATCHES as K2_PATCHES
from gpe_tpu_torch.experiments.k2_variants import build, clocks, use, write_variant
from gpe_tpu_torch.kernels import _build
from gpe_tpu_torch.kernels import fused_grad as k2
from gpe_tpu_torch.kernels import fused_residual as k1
from gpe_tpu_torch.kernels import rowcat_eval as k4
from gpe_tpu_torch.models.mlp import init_mlp
from gpe_tpu_torch.train.problem import make_batch

K4 = "rowcat_eval.cu"
CMN = "common.cuh"
# gemm_inplace's GEMM call, the anchor of the ffma patch
_GEMM = ("  float acc[4][8][4];\n"
         "  if constexpr (BF16) mma_gemm_bf16<4, 8, LX>(W, X, K, N, ROWS4, acc);\n"
         "  else mma_gemm<4, 8, LX, LW>(W, X, K, N, ROWS4, acc);\n")
# The f32 GEMM before the redesign: thread (warp, lane) owns units
# o0 + {0..3, 16..19} and rows m0 + 32g + {0..3}, float4 operand loads.
FFMA = [
    (K4, _GEMM,
     "  if constexpr (!BF16) {\n"
     "    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
     "    const int o0 = 32 * (warp & 3) + 4 * (lane >> 3);    // + {0..3, 16..19}\n"
     "    const int m0 = 128 * (warp >> 2) + 4 * (lane & 7);   // + 32 g + {0..3}\n"
     "    float acc[8][16];\n"
     "#pragma unroll\n"
     "    for (int e = 0; e < 8; ++e)\n"
     "#pragma unroll\n"
     "      for (int f = 0; f < 16; ++f) acc[e][f] = 0.f;\n"
     "#pragma unroll 2\n"
     "    for (int k = 0; k < K; ++k) {\n"
     "      const float* wk = W + k * LW + o0;\n"
     "      const float* xk = X + k * LX + m0;\n"
     "      const float4 a0 = *reinterpret_cast<const float4*>(wk);\n"
     "      const float4 a1 = *reinterpret_cast<const float4*>(wk + 16);\n"
     "      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};\n"
     "      float bv[16];\n"
     "#pragma unroll\n"
     "      for (int g = 0; g < 4; ++g) {\n"
     "        const float4 b = *reinterpret_cast<const float4*>(xk + 32 * g);\n"
     "        bv[4 * g] = b.x; bv[4 * g + 1] = b.y; bv[4 * g + 2] = b.z; bv[4 * g + 3] = b.w;\n"
     "      }\n"
     "#pragma unroll\n"
     "      for (int e = 0; e < 8; ++e)\n"
     "#pragma unroll\n"
     "        for (int f = 0; f < 16; ++f) acc[e][f] = fmaf(av[e], bv[f], acc[e][f]);\n"
     "    }\n"
     "    __syncthreads();\n"
     "    if (next_w) prefetch_w<LW>(next_w, next_k, W);\n"
     "#pragma unroll\n"
     "    for (int e = 0; e < 8; ++e) {\n"
     "      float* row = X + (o0 + (e < 4 ? e : 12 + e)) * LX + m0;\n"
     "#pragma unroll\n"
     "      for (int g = 0; g < 4; ++g)\n"
     "        *reinterpret_cast<float4*>(row + 32 * g) =\n"
     "            make_float4(acc[e][4 * g], acc[e][4 * g + 1], acc[e][4 * g + 2],\n"
     "                        acc[e][4 * g + 3]);\n"
     "    }\n"
     "    __syncthreads();\n"
     "    return;\n"
     "  }\n"
     "  float acc[4][8][4];\n"
     "  mma_gemm_bf16<4, 8, LX>(W, X, K, N, ROWS4, acc);\n"),
]
# name -> [(file, text, replacement[, occurrences, default 1])]
PATCHES = {
    "ffma": FFMA,
    "one_term": K2_PATCHES["one_term"],      # the shared mma_gemm, in common.cuh
    "stride4": [
        (K4, "template <bool BF16> constexpr int LDX = ROWS4 + (BF16 ? 4 : 8);\n"
             "template <bool BF16> constexpr int LDW = MAXW + (BF16 ? 4 : 8);\n",
         "template <bool BF16> constexpr int LDX = ROWS4 + 4;\n"
         "template <bool BF16> constexpr int LDW = MAXW + 4;\n"),
    ],
}
# name -> patches (every variant computes the sums)
VARIANTS = {
    "as_is": (),
    "ffma": ("ffma", "stride4"),
    "tf32x1": ("one_term",),
    "stride4": ("stride4",),
}

# K4's clock64 marks, the scheme of k1_variants.py (whose first patch
# declares the counters and the CLK macro in common.cuh)
PHASES = ["x load", "layer 0 (+ W_1 wait)", "hidden GEMMs + store",
          "activations (+ weight wait)", "last layer + Hamiltonian (+ set-up)"]
CLOCK_PATCH = [
    (K4, "  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;\n\n",
     "  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;\n  long long t_clk = clock64();\n\n"),
    (K4, "    __syncthreads();                   // the previous tile is done with xs, X, outv\n",
     "    __syncthreads();                   // the previous tile is done with xs, X, outv\n"
     "    CLK(4);\n"),
    (K4, "    __syncthreads();\n    // layer 0: v = x·W0",
     "    __syncthreads();\n    CLK(0);\n    // layer 0: v = x·W0"),
    (K4, "      __syncthreads();                 // W_l landed for every thread; X written\n",
     "      __syncthreads();                 // W_l landed for every thread; X written\n"
     "      CLK(l == 1 ? 1 : 3);\n"),
    (K4, "      wl += K * (MAXW / 4);\n", "      CLK(2);\n      wl += K * (MAXW / 4);\n"),
    (K4, "    __syncthreads();\n    // output layer (width 1)",
     "    __syncthreads();\n    CLK(n_gemm > 0 ? 3 : 1);\n    // output layer (width 1)"),
    (K4, 'extern "C" int gpe_k4_sums(',
     'extern "C" int gpe_k4_clocks(unsigned long long* host, int reset) {\n'
     "  static unsigned long long zero[512 * 16];\n"
     "  if (reset) return (int)cudaMemcpyToSymbol(gpe::g_clk, zero, sizeof zero);\n"
     "  return (int)cudaMemcpyFromSymbol(host, gpe::g_clk, sizeof zero);\n}\n\n"
     'extern "C" int gpe_k4_sums('),
]
# the sources built for as_is and the parent besides K4's
OTHERS = {"fused_residual": ("fused_residual.cu", k1), "fused_grad": ("fused_grad.cu", k2)}


def patches_of(variant: str) -> list:
    """The patch list of `variant`, or of `<variant>+clocks` ("parent+clocks":
    the clock marks alone, on the parent's sources)."""
    name, _, clocked = variant.partition("+")
    own = [] if name == "parent" else [x for p in VARIANTS[name] for x in PATCHES[p]]
    return own + (K1_CLOCK_PATCH[:1] + CLOCK_PATCH if clocked else [])


def ptxas_report(log: str, kernel: str = "k4_kernel") -> dict:
    """{"<kernel><D, BF16>": {"regs", "stack", "spill_stores", "spill_loads"}}
    from ptxas's -v report of a build (bytes a thread)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(kernel + r"ILi(\d)ELb(\d)", m.group(1))
            fn = f"{kernel}<{k.group(1)}, {bool(int(k.group(2)))}>" if k else None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if fn and m:
            out.setdefault(fn, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                          spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if fn and m:
            out.setdefault(fn, {})["regs"] = int(m.group(1))
    return out


def sass_report(lib_path: Path) -> dict:
    """{kernel: {"regs", "local" (bytes a thread: spills), opcode: count}} of
    a built library: registers and local memory from `cuobjdump -res-usage`,
    HMMA (tensor-core) and FFMA instructions counted in `cuobjdump -sass`."""
    tool = str(Path(_build._nvcc()).parent / "cuobjdump")
    run = lambda flag: subprocess.run([tool, flag, str(lib_path)], capture_output=True,
                                      text=True, check=True).stdout
    out: dict = {}
    for m in re.finditer(r"Function (\S+):\s*REG:(\d+)\s+STACK:\d+\s+SHARED:\d+\s+LOCAL:(\d+)",
                         run("-res-usage")):
        out[m.group(1)] = {"regs": int(m.group(2)), "local": int(m.group(3))}
    fn = None
    for line in run("-sass").splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?((?:HMMA|FFMA)\S*)", line)
        if fn and op:
            key = op.group(1) if op.group(1).startswith("HMMA") else "FFMA"
            counts = out.setdefault(fn, {})
            counts[key] = counts.get(key, 0) + 1
    return out


def k4_sass(lib_path: Path) -> dict:
    """sass_report of a K4 library, its k4_kernel instantiations alone, keyed
    as k4_kernel<D, BF16>."""
    out = {}
    for fn, rec in sass_report(lib_path).items():
        k = re.search(r"k4_kernelILi(\d)ELb(\d)", fn)
        if k:
            out[f"k4_kernel<{k.group(1)}, {bool(int(k.group(2)))}>"] = rec
    return out


def cases(dev):
    """([(label, library name, kernel call, plain call or None)] timed,
    [(label, kernel call, plain call)] for errors only): K4 f32 and K1 f32 at
    the benchmark's and the main shape, K3 sums (harmonic_paper) and K2 (main
    shape); then K4 f32 on the card tests' nets at weights x1 and x4."""
    timed = []
    for shape, spec in (("bench", bench_spec()),
                        ("main", EXPERIMENTS["gpe2d_ground_state"].spec)):
        batch = make_batch(spec, 0, device=dev)
        params = init_mlp(spec.layers, "xavier_uniform",
                          generator=torch.Generator().manual_seed(0), device=dev)
        a = (params, batch["x"], batch["V"], batch["w"], 5.0, 0.05,
             batch.get("base_val"), batch.get("base_lap"))
        kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
                  nonlinearity=spec.nonlinearity)
        for name, lib, mod in (("K4", "rowcat_eval", k4), ("K1", "fused_residual", k1)):
            timed.append((f"{name} {shape}", lib,
                          lambda mod=mod, a=a, kw=kw: mod.collocation_sums(*a, **kw),
                          lambda mod=mod, a=a, kw=kw: mod.collocation_sums_plain(*a, **kw)))
    k3 = k1_cases(dev)[1]
    timed.append((k3[0], "fused_residual", k3[1], k3[2]))
    spec = EXPERIMENTS["gpe2d_ground_state"].spec
    batch = make_batch(spec, 0, device=dev)
    params = init_mlp(spec.layers, "xavier_uniform",
                      generator=torch.Generator().manual_seed(0), device=dev)
    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    a = (params, batch["x"], batch["V"], batch["w"], 5.0, 0.05)
    base = (batch["base_val"], batch["base_lap"])
    cots = k1.sums_to_loss(k1.collocation_sums_plain(*a, *base, **kw),
                           batch["x"].shape[0], spec.norm_weight)[3]
    timed.append(("K2 main", "fused_grad",
                  lambda: k2.collocation_grads(*a, cots, *base, **kw), None))

    errs = []
    phys = ("shifted_tanh", 3.0, 0.5, "abs_power")
    for layers, n in (((2, 100, 100, 100, 1), 3000), ((2, 128, 128, 128, 1), 4096),
                      ((1, 48, 40, 40, 40, 1), 777)):
        for w_scale in (1.0, 4.0):
            xa = _scaled_inputs(layers, n, w_scale, dev)
            xa = (*xa[:4], 5.0, 0.05, *xa[4:], *phys)
            errs.append((f"K4 {list(layers)} weights x{w_scale:g}",
                         lambda xa=xa: k4.collocation_sums(*xa),
                         lambda xa=xa: k4.collocation_sums_plain(*xa)))
    return timed, errs


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
        raise SystemExit("k4_variants needs a CUDA device")
    dev = torch.device("cuda", 0)
    pin_full_f32()
    name, limit = card_info(dev)
    print(f"{name}, {limit}", flush=True)
    own = _build.build_all()                     # the port's own build
    print(json.dumps({"ptxas": "rowcat_eval", "kernels": ptxas_report(
        (own / "rowcat_eval.ptxas.log").read_text())}), flush=True)
    root = _build.BUILD_ROOT.parent / "k4_variants"
    clocked = [v for v in ("as_is", "parent") if args.clocks and v in args.variants]
    names = list(args.variants) + [v + "+clocks" for v in clocked]
    for v in names:
        write_variant(v, patches_of(v), root, args.parent if v.startswith("parent")
                      else None)
    t0 = time.perf_counter()
    libs = {"rowcat_eval": build({v: root / v for v in names}, K4, k4._bind)}
    both = {v: root / v for v in ("as_is", "parent") if v in args.variants}
    for lib, (src, mod) in OTHERS.items():
        libs[lib] = build(both, src, mod._bind) if both else {}
    print(f"builds in {time.perf_counter() - t0:.1f} s", flush=True)
    for v in names:
        print(json.dumps({"sass": v, "kernels": k4_sass(root / v / "librowcat_eval.so")}),
              flush=True)

    timed, errs = cases(dev)
    res = {v: {"variant": v, "card": name, "power_limit": limit} for v in args.variants}
    for v in args.variants:
        for label, lib, fn, plain in timed:
            if plain is not None and v in libs[lib]:
                use(libs[lib][v], lib)
                res[v][f"rel {label}"] = _rel(fn(), plain())
        use(libs["rowcat_eval"][v], "rowcat_eval")
        for label, fn, plain in errs:
            res[v][f"rel {label}"] = _rel(fn(), plain())
    order = list(args.variants) + list(reversed(args.variants))
    for _ in range(2):
        for v in order:
            for label, lib, fn, _ in timed:
                if v not in libs[lib]:
                    continue
                use(libs[lib][v], lib)
                res[v].setdefault(f"{label} ms", []).append(graph_ms(fn, 30, dev))
                res[v].setdefault(f"{label} call ms", []).append(time_ms(fn, 30, dev))
    for v in clocked:
        res[v]["clocks"] = {label: clocks(
            libs["rowcat_eval"][v + "+clocks"], fn, name="rowcat_eval", blocks=512,
            entry="gpe_k4_clocks", phases=PHASES)
            for label, lib, fn, _ in timed if lib == "rowcat_eval"}
    for r in res.values():
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
