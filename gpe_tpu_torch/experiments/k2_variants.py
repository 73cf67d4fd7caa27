"""K2's design choices, measured: compile-time variants of
`csrc/fused_grad.cu` (with `csrc/common.cuh`, which holds its 3xTF32 and
bf16 GEMM routines), each the source with a few lines replaced, built
beside the port's libraries (under `build/k2_variants/`, not committed) and
timed on the card in place of the real kernel.

    python -m gpe_tpu_torch.experiments.k2_variants [--clocks] [VARIANT ...]
    python -m gpe_tpu_torch.experiments.k2_variants --bf16 [--clocks]
        [--parent <checkout>/gpe_tpu_torch/csrc] [VARIANT ...]

Variants of the kernel as it stands (3xTF32 reverse GEMMs):
- as_is: the source unchanged;
- ffma_reverse: W̄ and backprop on `gemm_tile` (f32 FFMA) instead;
- tf32x1: one TF32 product per f32 product (hi·hi′ only), the error that
  the split removes;
- cvt_rna: hi rounded by `cvt.rna.tf32.f32` (emulated on sm_90a) instead
  of the integer add-and-mask;
- tile_guards: a guard on each m16n8 tile that lies past the widths;
- fragment_epilogue: W̄ added into the item's partial row straight from the
  mma fragments, not staged through shared memory;
- first_form: the last three together.
Ablations of the kernel before its reverse pass was redesigned (FFMA
reverse GEMMs, weights loaded per tile): where its time went; wrong by
design, timed only. Run them with that tree's package first on the path,
from a checkout of it (a `git archive` of that commit):

    PYTHONPATH=<parent checkout> python gpe_tpu_torch/experiments/k2_variants.py \
        as_is no_weight_loads no_reverse_gemms no_state_reads none_of_three

- no_weight_loads: the four per-tile weight loads skipped (`load_w`);
- no_reverse_gemms: W̄ and backprop skipped (zero accumulators);
- no_state_reads: the phase-(a)/(b) reads of the stored state replaced by
  values made from the indices;
- none_of_three: all three.

Variants of the bf16 operand mode (--bf16; K2-bf16 and K3-grads-bf16):
- as_is: the source unchanged (hidden forward and backprop GEMMs on bf16
  tensor cores, each f32 weight as three bf16 terms, common.cuh
  mma_gemm_bf16x3);
- ffma_forward: the hidden forward GEMMs back on FFMA `gemm_tile`, the
  bf16 forward before its redesign (the same products, summed in another
  order);
- bf16x2: the weight's lo term dropped (hi·b and mid·b only): the error
  that the third term removes;
- mma_chain: each slab's products added on the tensor core straight into
  the accumulator (its C input) instead of into a zeroed slab sum that an
  FADD adds: the error of the tensor core's truncating adder over the
  whole contraction;
- parent (with --parent DIR): the unpatched sources in DIR, a checkout's
  gpe_tpu_torch/csrc with the same C entry points.
First, for the port's own build, ptxas's registers and spills and
cuobjdump's HMMA/FFMA counts of each `grads_kernel<D, BF16>`.

For each variant: K2 at the main shape (gpe2d_ground_state: 50,176
points, [2,128,128,128,1], γ = 5, s = 0.05) and K3 grads at harmonic_paper
(six runs of [1,64,64,64,1] on 4,000 points), CUDA events, in turns over
the variants (forward then reverse order, twice) two ways: "ms", the
replays of a CUDA graph of one call (device time), and "call ms",
back-to-back calls with CUDA events (host work included); for the variants
that compute the gradient, its normalised error against the plain version
(--bf16: the bf16 plain version) there and with weights x1 and x4
(tests/test_torch_cuda.py's recipe), "err64" against the same plain
version run in float64 (bf16 operands rounded alike), and once the plain
version's own "plain err64". With --bf16 the same at the benchmark's
shape (50,176 points, [2,100,100,100,1]), timed too, and on the inputs of
the card test test_k2_bf16_keeps_parity_at_weights_x4 ("card x4"). --clocks
also builds as_is and fragment_epilogue (--bf16: as_is and the parent)
with clock64 marks after the phase barriers and prints cycles per phase
(thread 0, mean over blocks). One JSON line per variant. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from gpe_tpu_torch.bench import bench_spec, card_info, graph_ms, time_ms
from gpe_tpu_torch.device import pin_full_f32
from gpe_tpu_torch.experiments.configs import EXPERIMENTS
from gpe_tpu_torch.kernels import _build
from gpe_tpu_torch.kernels import fused_grad as k2
from gpe_tpu_torch.kernels import fused_residual as k1
from gpe_tpu_torch.models.mlp import init_mlp, params_from_numpy, stack_runs
from gpe_tpu_torch.train.problem import make_batch

K2 = "fused_grad.cu"
CMN = "common.cuh"         # the 3xTF32 GEMM routine that K2 shares with K1
GUARD = "if (i0 + 16 * mt < rows && j0 + 8 * nt < cols) "
# name -> [(file, text, replacement[, occurrences, default 1])]
PATCHES = {
    "ffma": [
        (K2, "          float acc[4][4][4];\n          mma_gemm(Z, X, N, K, M, acc);\n"
             "          __syncthreads();\n          mma_store(X, acc);",
         "          float acc[8][8];\n          gemm_tile(Z, X, N, acc);\n"
         "          __syncthreads();\n          store_tile(X, acc);"),
        (K2, "          float acc[4][4][4];\n          if constexpr (BF16) mma_gemm_bf16(Z, Y, M, "
             "K, N, acc);\n          else mma_gemm(Z, Y, M, K, N, acc);",
         "          float acc[8][8];\n          gemm_tile(Z, Y, M, acc);"),
        (K2, "          mma_store(Y, acc);", "          store_tile(Y, acc);"),
    ],
    "one_term": [
        (CMN, "      for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][nt], ah[mt], bl);",
         "      for (int mt = 0; mt < MT; ++mt) {}"),
        (CMN, "      for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][nt], al[mt], bh);",
         "      for (int mt = 0; mt < MT; ++mt) {}"),
    ],
    "cvt": [
        (CMN, "  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;",
         '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(a));'),
    ],
    "guards": [
        (CMN, "for (int mt = 0; mt < MT; ++mt) mma_tf32(",
         "for (int mt = 0; mt < MT; ++mt) " + GUARD + "mma_tf32(", 3),
    ],
    "frag_epilogue": [
        (K2, "template <int D, bool BF16>\n__global__ void __launch_bounds__(NT, 1)",
         "__device__ __forceinline__ void mma_add(float* dst, const float acc[4][4][4],\n"
         "                                        int K, int N) {\n"
         "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
         "  const int i0 = 64 * (warp & 1) + (lane >> 2), j0 = 32 * (warp >> 1) + 2 * (lane & 3);\n"
         "  for (int mt = 0; mt < 4; ++mt)\n"
         "    for (int nt = 0; nt < 4; ++nt)\n"
         "      for (int h = 0; h < 2; ++h) {\n"
         "        const int i = i0 + 16 * mt + 8 * h, j = j0 + 8 * nt;\n"
         "        if (i >= K) continue;\n"
         "        if (j < N) dst[i * N + j] += acc[mt][nt][2 * h];\n"
         "        if (j + 1 < N) dst[i * N + j + 1] += acc[mt][nt][2 * h + 1];\n"
         "      }\n"
         "}\n\n"
         "template <int D, bool BF16>\n__global__ void __launch_bounds__(NT, 1)"),
        (K2, "          mma_store(Y, acc);\n          __syncthreads();\n"
             "          add_tile(part + net.w_off[l], Y, K, N);",
         "          mma_add(part + net.w_off[l], acc, K, N);"),
    ],
    # the kernel before the redesign (FFMA reverse GEMMs, load_w per tile)
    "skip_wload": [
        ("common.cuh", "                                       float* dst, bool transpose) {\n",
         "                                       float* dst, bool transpose) {\n  return;\n"),
    ],
    "skip_rgemm": [
        (K2, "          float acc[8][8];\n          gemm_tile(Z, Y, M, acc);",
         "          float acc[8][8];\n#pragma unroll\n          for (int i = 0; i < 64; ++i)"
         " acc[i / 8][i % 8] = 0.f;"),
        (K2, "          float acc[8][8];\n          gemm_tile(Y, X, N, acc);",
         "          float acc[8][8];\n#pragma unroll\n          for (int i = 0; i < 64; ++i)"
         " acc[i / 8][i % 8] = 0.f;"),
    ],
    "skip_state": [
        (K2, "          const float z = so[r], lz = so[(C - 1) * T + r];",
         "          const float z = 1e-3f * (o + r), lz = 2e-3f * (o - r);"),
        (K2, "            jz[i] = so[(1 + i) * T + r];", "            jz[i] = 1e-3f * (o * (i + 2) + r);"),
        (K2, "            const float z = sk[r], lz = sk[(C - 1) * T + r];",
         "            const float z = 1e-3f * (k + r), lz = 2e-3f * (k - r);"),
        (K2, "              const float jz = sk[(1 + i) * T + r];",
         "              const float jz = 1e-3f * (k * (i + 2) + r);"),
    ],
}
# name -> (patches, computes the gradient)
VARIANTS = {
    "as_is": ((), True),
    "ffma_reverse": (("ffma",), True),
    "tf32x1": (("one_term",), True),
    "cvt_rna": (("cvt",), True),
    "tile_guards": (("guards",), True),
    "fragment_epilogue": (("frag_epilogue",), True),
    "first_form": (("cvt", "guards", "frag_epilogue"), True),
    "no_weight_loads": (("skip_wload",), False),
    "no_reverse_gemms": (("skip_rgemm",), False),
    "no_state_reads": (("skip_state",), False),
    "none_of_three": (("skip_wload", "skip_rgemm", "skip_state"), False),
}
CURRENT = [v for v, (_, grad) in VARIANTS.items() if grad]
# the bf16 operand mode's variants (--bf16), and its patches
BF16_PATCHES = {
    "ffma_fwd": [
        (CMN, "    } else if constexpr (BF16 && !RW) {  // K2: f32 weights as three bf16 terms\n",
         "    } else if constexpr (false) {\n"),
        (K2, "    if constexpr (BF16) {\n      gemm_bf16x3_inplace(Wl, X, K, N, C * T);",
         "    if constexpr (false) {\n      gemm_bf16x3_inplace(Wl, X, K, N, C * T);"),
    ],
    "two_term": [
        (CMN, "      for (int nt = 0; nt < NTL; ++nt) mma_bf16(sl[nt], al, bt[nt]);",
         "      for (int nt = 0; nt < NTL; ++nt) {}"),
    ],
    "chain": [       # the slab sums start from the accumulator, no FADD
        (CMN, "        for (int e = 0; e < 4; ++e) sl[nt][e] = 0.f;",
         "        for (int e = 0; e < 4; ++e) sl[nt][e] = acc[mt][nt][e];"),
        (CMN, "        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += sl[nt][e];",
         "        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = sl[nt][e];"),
    ],
}
BF16_VARIANTS = {
    "as_is": ((), True),
    "ffma_forward": (("ffma_fwd",), True),
    "bf16x2": (("two_term",), True),
    "mma_chain": (("chain",), True),
}

# clock64 marks (phase index, anchor after which the phase ends)
PHASES = ["tile start (xs, weight wait)", "forward", "last layer + cotangents",
          "(a) + weight wait", "(d) backprop GEMM + store", "(b) layer input",
          "(c) W̄ GEMM + bias sums", "(c) W̄ epilogue + copies", "(a) layer 0",
          "W̄ layer 0"]
CLOCK_PATCH = [
    (K2, "namespace gpe {\n",
     "namespace gpe {\n__device__ unsigned long long g_clk[256 * 16];\n"
     "#define CLK(ph) do { if (threadIdx.x == 0) { long long now_ = clock64(); "
     "g_clk[blockIdx.x * 16 + (ph)] += now_ - t_clk; t_clk = now_; } } while (0)\n"),
    (K2, "  float* store = scratch + (size_t)blockIdx.x * (L - 1) * MAXW * MAXW;\n",
     "  float* store = scratch + (size_t)blockIdx.x * (L - 1) * MAXW * MAXW;\n"
     "  long long t_clk = clock64();\n"),
    (K2, "      __syncthreads();                 // xs, and W₁, W₂ staged in Y, Z\n",
     "      __syncthreads();                 // xs, and W₁, W₂ staged in Y, Z\n      CLK(0);\n"),
    (K2, "      if (L >= 4) prefetch_w(",
     "      CLK(1);\n      if (L >= 4) prefetch_w("),
    (K2, "        const float* pre = store + (size_t)l * MAXW * MAXW;\n        __syncthreads();\n",
     "        const float* pre = store + (size_t)l * MAXW * MAXW;\n        __syncthreads();\n"
     "        CLK(l == L - 2 ? 2 : 7);\n"),
    (K2, "        __syncthreads();               // Z̄ in X and Y; W_lᵀ staged in Z\n",
     "        __syncthreads();               // Z̄ in X and Y; W_lᵀ staged in Z\n        CLK(3);\n"),
    (K2, "        // (b) this layer's input", "        CLK(4);\n        // (b) this layer's input"),
    (K2, "        }\n        __syncthreads();\n        // (c) W̄_l",
     "        }\n        __syncthreads();\n        CLK(5);\n        // (c) W̄_l"),
    (K2, "          __syncthreads();             // Y and Z are free\n",
     "          __syncthreads();             // Y and Z are free\n          CLK(6);\n"),
    (K2, "Σ_r z̄_ro\n          __syncthreads();\n",
     "Σ_r z̄_ro\n          __syncthreads();\n          CLK(8);\n"),
    (K2, "          break;\n", "          CLK(9);\n          break;\n"),
    (K2, 'extern "C" int gpe_k2_pad_weights(',
     'extern "C" int gpe_k2_clocks(unsigned long long* host, int reset) {\n'
     "  static unsigned long long zero[256 * 16];\n"
     "  if (reset) return (int)cudaMemcpyToSymbol(gpe::g_clk, zero, sizeof zero);\n"
     "  return (int)cudaMemcpyFromSymbol(host, gpe::g_clk, sizeof zero);\n}\n\n"
     'extern "C" int gpe_k2_pad_weights('),
]
CLOCKED = ["as_is", "fragment_epilogue"]


def write_variant(name: str, patches, root, csrc=None) -> None:
    """The sources in `csrc` (default: the port's csrc) with `patches`
    applied, into root/name/."""
    d = root / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc or _build.CSRC, d)
    for fname, text, new, *count in patches:
        p = d / fname
        s = p.read_text()
        want = count[0] if count else 1
        if s.count(text) != want:
            raise ValueError(f"variant {name}: {s.count(text)} matches in {fname} "
                             f"(want {want}) for {text[:60]!r}")
        p.write_text(s.replace(text, new))


def build(sources: dict, source: str = K2, bind=None) -> dict:
    """{name: dir} -> {name: loaded library} of dir/`source` (as
    dir/lib<stem>.so, so one dir can hold several), one nvcc each, all at
    once; `bind` (default: K2's) declares the entry points."""
    nvcc = _build._nvcc()
    out = f"lib{source.rsplit('.', 1)[0]}.so"
    procs = {n: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-I", str(d), "-o", str(d / out), str(d / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, d in sources.items()}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {n}:\n{log}")
        regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                       if "Used " in ln})
        print(f"built {n}: {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(sources[n] / out))
        lib.gpe_error_string.restype = ctypes.c_char_p
        lib.gpe_error_string.argtypes = [ctypes.c_int]
        (bind or k2._bind)(lib)
        libs[n] = lib
    return libs


def use(lib, name: str = "fused_grad") -> None:
    """Route the wrappers of csrc/`name`.cu to `lib` (the wrappers load
    libraries by name)."""
    with _build._lock:
        _build._libs[name] = lib


def grad_err(got, want) -> float:
    """Max over leaves (and runs) of max|Δ| / max|want|."""
    worst = 0.0
    for (gw, gb), (ww, wb) in zip(got, want):
        rows = gw.shape[0] if gw.ndim == 3 else 1
        for a, b in ((gw, ww), (gb, wb)):
            d = (a - b).abs().reshape(rows, -1).amax(dim=1)
            m = b.abs().reshape(rows, -1).amax(dim=1) + 1e-30
            worst = max(worst, float((d / m).max()))
    return worst


def _f64(v):
    """v with its floating tensors (in nested tuples too) in float64."""
    if isinstance(v, torch.Tensor) and v.is_floating_point():
        return v.double()
    if isinstance(v, tuple):
        return tuple(_f64(t) for t in v)
    return v


def cases(dev, bf16: bool = False):
    """[(label, kernel call, plain call, reference sums or None)]: the main
    shape, harmonic_paper's six runs (with bf16 then the benchmark's shape:
    the three timed), and the card tests' weights x1/x4 nets. f32: the
    reference sums are K1's; bf16 (the kernels in the bf16 operand mode
    against the bf16 plain versions, cotangents from K1-bf16's sums as the
    exact step takes them): None, the plain version's sums. The plain call
    takes a cast of its arguments (`_f64`: the same function in float64, the
    bf16 operands rounded alike)."""
    same = lambda v: v
    out = []
    dt = dict(compute_dtype=torch.bfloat16) if bf16 else {}
    grads_plain = k2.collocation_grads_bf16_plain if bf16 else k2.collocation_grads_plain
    runs_plain = (k2.collocation_grads_runs_bf16_plain if bf16
                  else k2.collocation_grads_runs_plain)
    tag = "-bf16" if bf16 else ""

    def single(label, spec):
        batch = make_batch(spec, 0, device=dev)
        params = init_mlp(spec.layers, "xavier_uniform",
                          generator=torch.Generator().manual_seed(0), device=dev)
        kw = dict(activation=spec.activation, p=spec.p, kinetic=spec.kinetic,
                  nonlinearity=spec.nonlinearity)
        a = (params, batch["x"], batch["V"], batch["w"], 5.0, 0.05)
        base = (batch.get("base_val"), batch.get("base_lap"))
        sums = k1.collocation_sums(*a, *base, **kw, **dt)
        c = k1.sums_to_loss(sums, batch["x"].shape[0], spec.norm_weight)[3]
        out.append((label, lambda: k2.collocation_grads(*a, c, *base, **kw, **dt),
                    lambda cast=same: grads_plain(*cast((*a, c, *base)), **kw),
                    None if bf16 else sums))

    single("K2" + tag, EXPERIMENTS["gpe2d_ground_state"].spec)

    cfg = EXPERIMENTS["harmonic_paper"]
    rspec, modes = cfg.spec, cfg.modes
    R = len(modes)
    rb = make_batch(rspec, modes[0], device=dev)
    per = [make_batch(rspec, m, device=dev) for m in modes]
    rbase = tuple(torch.stack([b[k] for b in per]).contiguous()
                  for k in ("base_val", "base_lap"))
    rparams = stack_runs([init_mlp(rspec.layers, "xavier_uniform",
                                   generator=torch.Generator().manual_seed(100 + r),
                                   device=dev) for r in range(R)])
    rkw = dict(activation=rspec.activation, p=rspec.p, kinetic=rspec.kinetic,
               nonlinearity=rspec.nonlinearity)
    ra = (rparams, rb["x"], rb["V"], rb["w"],
          torch.tensor([0.0, 0.5, 1.0, 2.0, 5.0, 10.0][:R], device=dev),
          torch.tensor([0.01 * (1 + r) for r in range(R)], device=dev))
    rsums = k1.collocation_sums_runs(*ra, *rbase, **rkw, **dt)
    rc = k1.sums_to_loss(rsums, rb["x"].shape[0], rspec.norm_weight)[3]
    out.append(("K3-grads-bf16" if bf16 else "K3 grads",
                lambda: k2.collocation_grads_runs(*ra, rc, *rbase, **rkw, **dt),
                lambda cast=same: runs_plain(*cast((*ra, rc, *rbase)), **rkw),
                None if bf16 else rsums))
    if bf16:
        single("K2-bf16 bench", bench_spec())

    phys = ("shifted_tanh", 3.0, 0.5, "abs_power")
    for layers, n in (((2, 128, 128, 128, 1), 4096), ((1, 64, 64, 64, 1), 4000)):
        for w_scale in (1.0, 4.0):
            rng = np.random.default_rng(0)
            p = params_from_numpy(
                [(w_scale * rng.normal(0.0, 1.0 / np.sqrt(k), (k, m)),
                  rng.normal(0.0, 0.1, m)) for k, m in zip(layers[:-1], layers[1:])],
                device=dev)
            t = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
            xa = (p, t(rng.uniform(-5.0, 5.0, (n, layers[0]))),
                  t(rng.uniform(0.0, 10.0, n)), t(np.full(n, 0.01)), 5.0, 0.05)
            xb = (t(rng.normal(0.0, 0.3, n)), t(rng.normal(0.0, 0.3, n)))
            s = k1.collocation_sums(*xa, *xb, *phys, **dt)
            cc = k1.sums_to_loss(s, n, 20.0)[3]
            out.append((f"{list(layers)} weights x{w_scale:g}",
                        lambda xa=xa, xb=xb, cc=cc: k2.collocation_grads(
                            *xa, cc, *xb, *phys, **dt),
                        lambda cast=same, xa=xa, xb=xb, cc=cc: grads_plain(
                            *cast((*xa, cc, *xb)), *phys),
                        None if bf16 else s))
            if bf16 and w_scale == 4.0:        # test_k2_bf16_keeps_parity_at_weights_x4
                out.append(card_x4(layers, xa, xb, phys, runs=6 if layers[0] == 1 else None))
    return out


def card_x4(layers, xa, xb, phys, runs=None):
    """tests/test_torch_cuda.py's K2-bf16 x4 case on the same inputs: its
    fixed cotangents and, with `runs`, its run stack (weights and bases
    times 1 + 0.05·r, γ from 1 to 5)."""
    p, x, V, w = xa[:4]
    dev = x.device
    cots = torch.tensor([2e-4, -8e-4, 8e-4, 0.3], device=dev)
    gamma, scale, (bval, blap) = 5.0, 0.05, xb
    grads, plain = k2.collocation_grads, k2.collocation_grads_bf16_plain
    if runs:
        stack = lambda t: torch.stack([t * (1.0 + 0.05 * r) for r in range(runs)])
        p = tuple((stack(W), stack(b)) for W, b in p)
        bval, blap = stack(bval), stack(blap)
        gamma = torch.linspace(1.0, 5.0, runs, device=dev)
        scale = torch.full((runs,), 0.05, device=dev)
        cots = torch.stack([cots] * runs)
        grads, plain = k2.collocation_grads_runs, k2.collocation_grads_runs_bf16_plain
    a = (p, x, V, w, gamma, scale, cots, bval, blap)
    return (f"card x4 {list(layers)}" + (f" R{runs}" if runs else ""),
            lambda: grads(*a, *phys, compute_dtype=torch.bfloat16),
            lambda cast=lambda v: v: plain(*cast(a), *phys), None)


def k2_resources(build_dir: Path) -> dict:
    """ptxas's registers and spills and cuobjdump's HMMA/FFMA counts of each
    grads_kernel<D, BF16> in a build of fused_grad.cu (k4_variants.py's
    readers)."""
    from gpe_tpu_torch.experiments.k4_variants import ptxas_report, sass_report
    out = ptxas_report((build_dir / "fused_grad.ptxas.log").read_text(), "grads_kernel")
    for fn, rec in sass_report(build_dir / "libfused_grad.so").items():
        k = re.search(r"grads_kernelILi(\d)ELb(\d)", fn)
        if k:
            out.setdefault(f"grads_kernel<{k.group(1)}, {bool(int(k.group(2)))}>",
                           {}).update(rec)
    return out


def clocks(lib, fn, reps: int = 10, entry: str = "gpe_k2_clocks", phases=PHASES,
           name: str = "fused_grad", blocks: int = 256) -> dict:
    """Cycles per phase per launch (thread 0 of each block, mean over the
    blocks that ran) of the instrumented build `lib` of csrc/`name`.cu,
    read through its C entry `entry` (16 counters for each of `blocks`)."""
    read = getattr(lib, entry)
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    use(lib, name)
    fn()
    torch.cuda.synchronize()
    _build.check(lib, read(None, 1), entry)
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host = (ctypes.c_ulonglong * (blocks * 16))()
    _build.check(lib, read(ctypes.cast(host, ctypes.c_void_p), 0), entry)
    c = np.array(host[:], dtype=np.float64).reshape(blocks, 16)[:, :len(phases)]
    c = c[c.sum(axis=1) > 0].mean(axis=0) / reps
    return {"kcycles": float(c.sum() / 1e3),
            "share": {ph: float(x / c.sum()) for ph, x in zip(phases, c)}}


def patches_of(variant: str, bf16: bool) -> list:
    """The patch list of `variant`, or of `<variant>+clocks` ("parent+clocks":
    the clock marks alone, on the parent's sources)."""
    name, _, clocked = variant.partition("+")
    table, patches = (BF16_VARIANTS, BF16_PATCHES) if bf16 else (VARIANTS, PATCHES)
    own = [] if name == "parent" else [x for p in table[name][0] for x in patches[p]]
    return own + (CLOCK_PATCH if clocked else [])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="VARIANT",
                    help=f"any of {', '.join(VARIANTS)} (default: {', '.join(CURRENT)}); "
                         f"with --bf16 any of {', '.join(BF16_VARIANTS)} or parent "
                         "(default: all, and parent with --parent)")
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 operand mode's variants (K2-bf16, K3-grads-bf16)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="with --bf16: the unpatched sources of the variant parent")
    ap.add_argument("--clocks", action="store_true",
                    help="also the per-phase cycles of as_is and fragment_epilogue "
                         "(--bf16: of as_is and the parent, if timed)")
    args = ap.parse_args(argv)
    if args.bf16:
        known = set(BF16_VARIANTS) | ({"parent"} if args.parent else set())
        args.variants = args.variants or list(BF16_VARIANTS) + ["parent"] * bool(args.parent)
    else:
        known = set(VARIANTS)
        args.variants = args.variants or CURRENT
    unknown = sorted(set(args.variants) - known)
    if unknown:
        ap.error(f"unknown variants {unknown} (parent needs --bf16 --parent)")
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants needs a CUDA device")
    dev = torch.device("cuda", 0)
    pin_full_f32()
    name, limit = card_info(dev)
    print(f"{name}, {limit}", flush=True)
    if args.bf16:                                # the port's own build
        print(json.dumps({"resources": k2_resources(_build.build_all())}), flush=True)
    root = _build.BUILD_ROOT.parent / "k2_variants"
    clocked = ([v for v in ("as_is", "parent") if v in args.variants] if args.bf16
               else CLOCKED) if args.clocks else []
    names = list(args.variants) + [v + "+clocks" for v in clocked]
    for v in names:
        write_variant(v, patches_of(v, args.bf16), root,
                      args.parent if v.startswith("parent") else None)
    t0 = time.perf_counter()
    libs = build({v: root / v for v in names})
    print(f"{len(libs)} builds in {time.perf_counter() - t0:.1f} s", flush=True)

    table = BF16_VARIANTS if args.bf16 else VARIANTS
    computes = lambda v: v == "parent" or table[v][1]
    work = cases(dev, args.bf16)
    timed = work[:3] if args.bf16 else work[:2]
    refs = [plain(_f64)[0] for _, _, plain, _ in work]
    print(json.dumps({"plain err64": {label: grad_err(plain()[0], ref) for (label, _, plain, _),
                                      ref in zip(work, refs)}}), flush=True)
    res = {v: {"variant": v, "card": name, "power_limit": limit} for v in args.variants}
    for v in args.variants:
        if not computes(v):
            continue
        use(libs[v])
        for (label, fn, plain, sums), ref in zip(work, refs):
            (grads, s), (pgrads, ps) = fn(), plain()
            res[v][f"err {label}"] = grad_err(grads, pgrads)
            res[v][f"err64 {label}"] = grad_err(grads, ref)
            s_ref = ps if sums is None else sums
            res[v][f"sums rel {label}"] = float(((s - s_ref).abs() / s_ref.abs()).max())
    order = list(args.variants) + list(reversed(args.variants))
    for _ in range(2):
        for v in order:
            use(libs[v])
            for label, fn, _, _ in timed:
                iters = 50 if label.startswith("K3") else 30
                res[v].setdefault(f"{label} ms", []).append(graph_ms(fn, iters, dev))
                res[v].setdefault(f"{label} call ms", []).append(time_ms(fn, iters, dev))
    for v in clocked:
        res.setdefault(v, {"variant": v, "card": name, "power_limit": limit})
        res[v]["clocks"] = {label: clocks(libs[v + "+clocks"], fn)
                            for label, fn, _, _ in timed}
    for r in res.values():
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
