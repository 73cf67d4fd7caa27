"""K1's design choices, measured: compile-time variants of
`csrc/fused_residual.cu` (K1 and its run axis, K3 sums), each the source
with a few lines replaced, built beside the port's libraries (under
`build/k1_variants/`, not committed) and timed on the card in place of the
real kernel. The helpers are k2_variants.py's.

    python -m gpe_tpu_torch.experiments.k1_variants [--clocks] [--csrc DIR]
        [--parent DIR] [VARIANT ...]

Variants of the kernel as it stands (3xTF32 forward GEMMs):
- as_is: the source unchanged;
- ffma_forward: the f32 forward GEMMs on FFMA `gemm_tile` (the arithmetic
  before the redesign, with the new weight staging and item walk; one
  block an SM, as gemm_tile needs 128-row tiles; f32 only: its bf16 mode
  would skip the weights' rounding, see bf16_variants.py's ffma);
- tf32x1: one TF32 product per f32 product (hi·hi′ only), the error that
  the split removes;
- one_block_per_sm: no narrow mode (128-row tiles, one block an SM, the
  grid at most the SM count, whatever the widths);
- half_warps: that, and a layer of width ≤ 64 on mma_gemm's 64 x 32 warp
  blocks, so half of the warps idle (the layout before the 32 x 32 one).
Ablations of the kernel before its redesign (FFMA forward, weights loaded
per item), wrong by design where noted; they patch that tree's sources, so
run them with `--csrc <checkout of it>/gpe_tpu_torch/csrc` (the C entry
point is unchanged, so the port's wrapper drives either):
- no_weight_loads: a block stages hidden weights for its first item only
  (wrong for every later item of another run);
- no_hidden_gemms: the hidden-layer GEMMs skipped, zero output (wrong);
- gemm_rows_cut: the FFMA GEMM computes only the output rows below the
  layer's width (a thread's upper 4 x 8 block is skipped when N ≤ 64).

--parent DIR adds the variant "parent": the unpatched sources in DIR (a
checkout's gpe_tpu_torch/csrc with the same C entry point), timed in turns
with the others. --clocks also builds as_is with clock64 marks after the
phase barriers and prints cycles per phase (thread 0, summed over a launch,
mean over the blocks that ran).

For each variant: K1 at the main shape (gpe2d_ground_state: 50,176 points,
[2,128,128,128,1], γ = 5, s = 0.05) and K3 sums at harmonic_paper (six runs
of [1,64,64,64,1] on 4,000 points), timed in turns over the variants
(forward then reverse order, twice) two ways with CUDA events: "ms", the
replays of a CUDA graph of one call (device time: the kernels and the
wrapper's few tensor ops), and "call ms", back-to-back calls (host work
included; the run-mode call is host-bound). For the variants that compute
the sums, their largest relative error per sum against the plain version
there and at weights x1 and x4 (tests/test_torch_cuda.py's recipe). One
JSON line per variant. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from gpe_tpu_torch.bench import card_info, graph_ms, time_ms
from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.experiments.configs import EXPERIMENTS
from gpe_tpu_torch.experiments.k2_variants import PATCHES as K2_PATCHES
from gpe_tpu_torch.experiments.k2_variants import build, clocks, use, write_variant
from gpe_tpu_torch.kernels import _build
from gpe_tpu_torch.kernels import fused_residual as k1
from gpe_tpu_torch.models.mlp import init_mlp, params_from_numpy, stack_runs
from gpe_tpu_torch.train.problem import make_batch

K1 = "fused_residual.cu"
CMN = "common.cuh"
# name -> [(file, text, replacement[, occurrences, default 1])]
PATCHES = {
    "ffma": [
        (K1, "forward_tile<D, BF16, true, WROWS>(", "forward_tile<D, BF16, false, WROWS>("),
    ],
    "wide": [       # one block an SM, 128-row tiles, whatever the widths
        (K1, "  bool narrow = !bf16 && n_layers - 2 <= 2;\n", "  bool narrow = false;\n"),
    ],
    "one_term": K2_PATCHES["one_term"],      # the shared mma_gemm, in common.cuh
    "half_warps": [
        (CMN, "      if (WROWS <= 64 || N <= 64) {      // all 8 warps on 32 x 32 blocks",
         "      if (false) {"),
    ],
    # the kernel before the redesign
    "skip_wload": [
        (K1, "    if (resident)\n      for (int l = 1; l <= L - 2; ++l)",
         "    if (resident && item == (int)blockIdx.x)\n      for (int l = 1; l <= L - 2; ++l)"),
    ],
    "skip_gemm": [
        (CMN, "    gemm_tile(Wl, X, K, acc);            // C[o][m] = sum_k W[k][o] X[k][m]\n",
         "#pragma unroll\n    for (int i = 0; i < 64; ++i) acc[i / 8][i % 8] = 0.f;\n"),
    ],
    "rows_cut": [
        (CMN, "// Forward-Laplacian pass of one tile",
         "// gemm_tile with the rows at or past N left out: for N <= 64 only the\n"
         "// lower 4 x 8 block of each thread's fragment (rows 4ti + e < 64).\n"
         "__device__ __forceinline__ void gemm_rows(const float* __restrict__ A,\n"
         "                                          const float* __restrict__ B, int P,\n"
         "                                          int N, float acc[8][8]) {\n"
         "  if (N > 64) { gemm_tile(A, B, P, acc); return; }\n"
         "  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;\n"
         "#pragma unroll\n"
         "  for (int i = 0; i < 8; ++i)\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;\n"
         "  const float* a = A + 4 * ti;\n"
         "  const float* b = B + 4 * tj;\n"
         "#pragma unroll 2\n"
         "  for (int q = 0; q < P; ++q) {\n"
         "    const float4 a0 = *reinterpret_cast<const float4*>(a + q * LDS);\n"
         "    const float4 b0 = *reinterpret_cast<const float4*>(b + q * LDS);\n"
         "    const float4 b1 = *reinterpret_cast<const float4*>(b + q * LDS + 64);\n"
         "    const float av[4] = {a0.x, a0.y, a0.z, a0.w};\n"
         "    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};\n"
         "#pragma unroll\n"
         "    for (int i = 0; i < 4; ++i)\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);\n"
         "  }\n"
         "}\n\n"
         "// Forward-Laplacian pass of one tile"),
        (CMN, "    gemm_tile(Wl, X, K, acc);            // C[o][m] = sum_k W[k][o] X[k][m]\n",
         "    gemm_rows(Wl, X, K, N, acc);\n"),
    ],
}
# name -> (patches, computes the sums)
VARIANTS = {
    "as_is": ((), True),
    "ffma_forward": (("ffma", "wide"), True),
    "tf32x1": (("one_term",), True),
    "one_block_per_sm": (("wide",), True),
    "half_warps": (("half_warps", "wide"), True),
    "no_weight_loads": (("skip_wload",), False),
    "no_hidden_gemms": (("skip_gemm",), False),
    "gemm_rows_cut": (("rows_cut",), True),
}
CURRENT = ["as_is", "ffma_forward", "tf32x1", "one_block_per_sm", "half_warps"]

# clock64 marks: thread 0 adds the cycles since its last mark to its
# block's counter of the phase that just ended (marks follow barriers)
PHASES = ["x load (+ weight wait)", "weight staging", "layer 0", "hidden GEMMs + store",
          "activations", "last layer + Hamiltonian", "block reduction + item start"]
CLOCK_PATCH = [
    (CMN, "namespace gpe {\n",
     "namespace gpe {\n__device__ unsigned long long g_clk[512 * 16];\n"
     "#define CLK(ph) do { if (threadIdx.x == 0) { long long now_ = clock64(); "
     "g_clk[blockIdx.x * 16 + (ph)] += now_ - t_clk; t_clk = now_; } } while (0)\n"),
    (CMN, "  constexpr int C = D + 2, T = MAXW / C;\n  const int L = net.n_layers;\n"
          "  // layer 0",
     "  constexpr int C = D + 2, T = MAXW / C;\n  const int L = net.n_layers;\n"
     "  long long t_clk = clock64();\n  // layer 0"),
    (CMN, "    __syncthreads();\n    if (stream) {\n",
     "    __syncthreads();\n    CLK(l == 1 ? 2 : 4);\n    if (stream) {\n"),
    (CMN, "    __syncthreads();\n    const float* bl = prm + net.b_off[l];\n",
     "    __syncthreads();\n    CLK(3);\n    const float* bl = prm + net.b_off[l];\n"),
    (CMN, "  }\n  __syncthreads();\n}\n\n// Last (linear",
     "  }\n  __syncthreads();\n  CLK(L >= 3 ? 4 : 2);\n}\n\n// Last (linear"),
    (K1, "  const int n_tiles = (n + T - 1) / T;\n",
     "  const int n_tiles = (n + T - 1) / T;\n  long long t_clk = clock64();\n"),
    (K1, "    __syncthreads();                 // the previous item is done with Wsm, red\n",
     "    __syncthreads();                 // the previous item is done with Wsm, red\n"
     "    CLK(6);\n"),
    (K1, "    const float gamma = scal[2 * run], scale = scal[2 * run + 1];\n",
     "    __syncthreads();\n    CLK(1);\n"
     "    const float gamma = scal[2 * run], scale = scal[2 * run + 1];\n"),
    (K1, "      const int base = tile * T;\n      __syncthreads();\n",
     "      const int base = tile * T;\n      __syncthreads();\n      CLK(5);\n"),
    (K1, "      __syncthreads();\n      forward_tile<D, BF16",
     "      __syncthreads();\n      CLK(0);\n      forward_tile<D, BF16"),
    (K1, "      last_layer<D, BF16>(X, prm_r, net, outv);\n",
     "      t_clk = clock64();\n      last_layer<D, BF16>(X, prm_r, net, outv);\n"),
    (K1, "    }\n    __syncthreads();\n    if (threadIdx.x < T) {\n",
     "    }\n    __syncthreads();\n    CLK(5);\n    if (threadIdx.x < T) {\n"),
    (K1, 'extern "C" int gpe_k1_sums_runs(',
     'extern "C" int gpe_k1_clocks(unsigned long long* host, int reset) {\n'
     "  static unsigned long long zero[512 * 16];\n"
     "  if (reset) return (int)cudaMemcpyToSymbol(gpe::g_clk, zero, sizeof zero);\n"
     "  return (int)cudaMemcpyFromSymbol(host, gpe::g_clk, sizeof zero);\n}\n\n"
     'extern "C" int gpe_k1_sums_runs('),
]
CLOCKED = ["as_is"]


def patches_of(variant: str) -> list:
    """The patch list of `variant`, or of `<variant>+clocks`."""
    name, _, clocked = variant.partition("+")
    return [x for p in VARIANTS[name][0] for x in PATCHES[p]] + (CLOCK_PATCH if clocked
                                                                  else [])


def _rel(got, want) -> float:
    return float(((got - want).abs() / want.abs()).max())


def _scaled_inputs(layers, n, w_scale, dev, runs=None):
    """The card tests' recipe: seeded normal weights scaled by w_scale
    (run-stacked when runs is set), x in [-5, 5]^d, V in [0, 10], w = 0.01,
    normal bases."""
    rng = np.random.default_rng(0)
    lead = () if runs is None else (runs,)
    p = params_from_numpy(
        [(w_scale * rng.normal(0.0, 1.0 / np.sqrt(k), lead + (k, m)),
          rng.normal(0.0, 0.1, lead + (m,))) for k, m in zip(layers[:-1], layers[1:])],
        device=dev)
    t = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    base = lead + (n,)
    return (p, t(rng.uniform(-5.0, 5.0, (n, layers[0]))), t(rng.uniform(0.0, 10.0, n)),
            t(np.full(n, 0.01)), t(rng.normal(0.0, 0.3, base)), t(rng.normal(0.0, 0.3, base)))


def cases(dev):
    """[(label, kernel call, plain call)]: K1 at the main shape, K3 sums at
    harmonic_paper's six runs, then K1 and K3 sums on the card tests'
    weights x1/x4 nets (the first two are timed)."""
    spec = EXPERIMENTS["gpe2d_ground_state"].spec
    batch = make_batch(spec, 0, device=dev)
    params = init_mlp(spec.layers, "xavier_uniform",
                      generator=torch.Generator().manual_seed(0), device=dev)
    kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
              nonlinearity=spec.nonlinearity)
    a = (params, batch["x"], batch["V"], batch["w"], 5.0, 0.05,
         batch["base_val"], batch["base_lap"])
    out = [("K1", lambda: k1.collocation_sums(*a, **kw),
            lambda: k1.collocation_sums_plain(*a, **kw))]

    cfg = EXPERIMENTS["harmonic_paper"]
    rspec, modes = cfg.spec, cfg.modes
    R = len(modes)
    rb = make_batch(rspec, modes[0], device=dev)
    per = [make_batch(rspec, m, device=dev) for m in modes]
    rparams = stack_runs([init_mlp(rspec.layers, "xavier_uniform",
                                   generator=torch.Generator().manual_seed(100 + r),
                                   device=dev) for r in range(R)])
    rkw = dict(activation=rspec.activation, p=rspec.p, kinetic=rspec.kinetic,
               nonlinearity=rspec.nonlinearity)
    ra = (rparams, rb["x"], rb["V"], rb["w"],
          torch.tensor([0.0, 0.5, 1.0, 2.0, 5.0, 10.0][:R], device=dev),
          torch.tensor([0.01 * (1 + r) for r in range(R)], device=dev),
          *(torch.stack([b[k] for b in per]).contiguous() for k in ("base_val", "base_lap")))
    out.append(("K3 sums", lambda: k1.collocation_sums_runs(*ra, **rkw),
                lambda: k1.collocation_sums_runs_plain(*ra, **rkw)))

    phys = ("shifted_tanh", 3.0, 0.5, "abs_power")
    for layers, n, runs in (((2, 128, 128, 128, 1), 4096, None),
                            ((1, 64, 64, 64, 1), 4000, None),
                            ((1, 64, 64, 64, 1), 4000, 6)):
        for w_scale in (1.0, 4.0):
            p, x, V, w, bv, bl = _scaled_inputs(layers, n, w_scale, dev, runs)
            if runs is None:
                xa = (p, x, V, w, 5.0, 0.05, bv, bl)
                fn, plain = k1.collocation_sums, k1.collocation_sums_plain
            else:
                g = torch.linspace(0.0, 5.0, runs, device=dev)
                s = torch.linspace(0.01, 0.1, runs, device=dev)
                xa = (p, x, V, w, g, s, bv, bl)
                fn, plain = k1.collocation_sums_runs, k1.collocation_sums_runs_plain
            label = f"{'K3 sums' if runs else 'K1'} {list(layers)} weights x{w_scale:g}"
            out.append((label, lambda fn=fn, xa=xa: fn(*xa, *phys),
                        lambda plain=plain, xa=xa: plain(*xa, *phys)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="VARIANT",
                    help=f"any of {', '.join(VARIANTS)} (default: {', '.join(CURRENT)})")
    ap.add_argument("--clocks", action="store_true",
                    help=f"also the per-phase cycles of {', '.join(CLOCKED)}")
    ap.add_argument("--csrc", type=Path, default=None,
                    help="the kernel sources to patch (default: the port's csrc)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="also time the unpatched sources in this directory")
    args = ap.parse_args(argv)
    args.variants = args.variants or CURRENT
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants needs a CUDA device")
    dev = torch.device("cuda", 0)
    pin_full_f32()
    name, limit = card_info(dev)
    print(f"{name}, {limit}", flush=True)
    root = _build.BUILD_ROOT.parent / "k1_variants"
    names = list(args.variants) + ([v + "+clocks" for v in CLOCKED] if args.clocks else [])
    for v in names:
        write_variant(v, patches_of(v), root, args.csrc)
    if args.parent:
        write_variant("parent", [], root, args.parent)
        args.variants.append("parent")
    t0 = time.perf_counter()
    libs = build({v: root / v for v in names + ["parent"] * bool(args.parent)},
                 K1, k1._bind)
    print(f"{len(libs)} builds in {time.perf_counter() - t0:.1f} s", flush=True)

    work = cases(dev)
    res = {v: {"variant": v, "card": name, "power_limit": limit} for v in args.variants}
    for v in args.variants:
        if v != "parent" and not VARIANTS[v][1]:
            continue
        use(libs[v], "fused_residual")
        for label, fn, plain in work:
            res[v][f"rel {label}"] = _rel(fn(), plain())
    order = list(args.variants) + list(reversed(args.variants))
    for _ in range(2):
        for v in order:
            use(libs[v], "fused_residual")
            for (label, fn, _), iters in zip(work[:2], (30, 50)):
                res[v].setdefault(f"{label} ms", []).append(graph_ms(fn, iters, dev))
                res[v].setdefault(f"{label} call ms", []).append(time_ms(fn, iters, dev))
    for v in CLOCKED if args.clocks else ():
        res.setdefault(v, {"variant": v, "card": name, "power_limit": limit})
        res[v]["clocks"] = {label: clocks(libs[v + "+clocks"], fn, entry="gpe_k1_clocks",
                                          phases=PHASES, name="fused_residual",
                                          blocks=512)
                            for label, fn, _ in work[:2]}
    for r in res.values():
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
