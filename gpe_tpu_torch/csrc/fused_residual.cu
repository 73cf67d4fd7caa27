// K1 — fused GPE collocation sums on Hopper, for R independent runs (K3).
//
// Replaces: gpe_tpu/pallas/fused_residual.py, make_pallas_loss_eval →
// collocation_sums (the Pallas `kernel`), with n_runs = 1 (K1) and its
// lane-packed n_runs = M > 1 mode (K3, contract in gpe_tpu/pallas/packing.py).
// Per tile of points it runs the whole forward-Laplacian MLP (value, d
// Jacobian rows, Laplacian through every layer), forms u = base + s·net,
// Δu = base_lap + s·Δnet, Hu = −c·Δu + V·u + γ𝒩(u), and sums
// S = (Σ(Hu)², Σu·Hu, Σu², Σu²w) for each run.
//
// Bound on this card: operations. The hidden layers are (C·T = 128) x K x N
// GEMMs per tile, ~0.26 MFLOP per point at width 128 (~0.05 MFLOP at the 1D
// paper width 64) against ~24 bytes of input per point. f32 parity needs
// each product in 3xTF32 (three TF32 tensor-core products), so the least
// time is the GEMM FLOPs at the dense TF32 rate over three (495/3 = 165
// TFLOP/s), the roof chip_smoke.py holds K1 to; with bf16 operands one
// bf16 tensor-core product each (989 TFLOP/s dense). Measured by clock64
// per phase (experiments/k1_variants.py --clocks), the f32 GEMMs take ~60%
// of a launch at width 128 and ~38% at width 64; the activations (σ, σ′, σ″
// recomputed per unit and point), layer 0 and the last layer most of the
// rest (the bf16 mode's split: experiments/bf16_variants.py --clocks).
//
// Design:
// - Run axis, not lane packing. The TPU packs M = 128/w narrow nets
//   block-diagonally into one 128-lane net because its lanes are fixed;
//   here each work item is (run, slot) and runs that run's own net with its
//   own γ, s and base arrays (run-major buffers, see common.cuh), so only
//   real weights are read and no zero off-diagonal block is multiplied.
//   One launch covers the whole ensemble; a run's sums are bit-equal to a
//   launch of that run alone (same tile walk, same fixed-order reduction).
// - Persistent blocks of 256 threads, one per SM (grid ≤ SM count), or two
//   for a narrow net (f32, ≤ 2 hidden GEMM layers, hidden widths ≤ 64): its
//   state and weight tiles keep 64 rows (~101 KB), the block ≤ 128
//   registers, and the second block fills the first one's barrier waits
//   (−13% at the 1D paper shape, where an item is one tile).
//   Each block takes a contiguous share of the R·S items, so its items share
//   a run and, when the net has ≤ 2 hidden GEMM layers, the run's weights
//   are staged into shared memory once per block and run (~200 KB with the
//   state tile at width 128) — at the 1D paper shape an item is one tile,
//   and staging per item cost 22% of the launch. The copy is 4-byte
//   cp.async straight from the flat parameters (any width, no padded copy,
//   no extra launch), waited for after the tile's x load; columns past a
//   layer's width stay zero from the block's start. Deeper nets stream each
//   layer's weights per tile. The tile's channel state stays in shared
//   memory across layers.
// - f32 GEMMs on tensor cores in 3xTF32 (common.cuh mma_gemm, K2's reverse
//   routine: hi rounded by the integer trick, the three terms grouped across
//   tiles, small products first, no per-tile guards), the output cut to the
//   layer's width and stored through shared memory. Width > 64: 64 x 32
//   warp blocks; width ≤ 64: 32 x 32 blocks, so all 8 warps — on all four
//   sub-partitions of the SM — share the N x 128 output (with 64 x 32 blocks
//   half of them idled).
// - Each item writes four partial sums to its own row; a second launch sums
//   each run's rows in a fixed order (in double) — deterministic.
// - Ragged edge: points past n load x = 0 and are masked out of the sums (a
//   padded point's u(0) ≠ 0 must not contribute).
// - compute_dtype = bf16 (template flag BF16, single runs and the run axis,
//   as JAX's n_runs takes it): every GEMM operand is a bf16 value — x and the
//   state rounded where they are written (common.cuh `op`), the hidden
//   weights staged as f32 by the same cp.async and rounded as the GEMM
//   packs them — and the hidden GEMMs run on bf16 tensor cores
//   (common.cuh mma_gemm_bf16: mma.sync m16n8k16, f32 accumulators, the
//   same warp blocks and width cut as the f32 mode). Products are exact;
//   sums, biases and activations stay f32.
#include "common.cuh"

namespace gpe {

// NARROW (f32, ≤ 2 hidden GEMM layers, every hidden width ≤ 64): the state
// and weight tiles keep 64 rows, ~101 KB in all, so two blocks share an SM.
template <int D, bool BF16, bool NARROW>
__global__ void __launch_bounds__(NT, NARROW ? 2 : 1)
sums_kernel(const float* __restrict__ x, const float* __restrict__ V,
            const float* __restrict__ w, const float* __restrict__ bval,
            int bval_stride, const float* __restrict__ blap, int blap_stride,
            const float* __restrict__ prm, Net net, Phys ph,
            const float* __restrict__ scal, int n, int R, int S, int resident,
            float* __restrict__ partial) {
  constexpr int C = D + 2, T = MAXW / C;
  constexpr int WROWS = NARROW ? 64 : MAXW, TILE = WROWS * LDS;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* Wsm = X + TILE;
  __shared__ float xs[T * D];
  __shared__ float outv[MAXW];
  __shared__ float red[4 * T];

  const int L = net.n_layers;
  const int n_tiles = (n + T - 1) / T;
  const int n_w = resident ? (L - 2 > 0 ? L - 2 : 0) : 1;
  // the state tile and the weight tiles start zero: staged weights then
  // only fill a layer's real widths (the same for every run)
  for (int i = threadIdx.x; i < (1 + n_w) * TILE / 4; i += NT)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // a contiguous share of the R·S items, so consecutive items share a run
  const int first = (int)((long)blockIdx.x * R * S / gridDim.x);
  const int last = (int)((long)(blockIdx.x + 1) * R * S / gridDim.x);
  int staged = -1;                   // the run whose weights sit in Wsm
  for (int item = first; item < last; ++item) {
    const int run = item / S, slot = item % S;
    const float* prm_r = prm + (size_t)run * net.n_params;
    const float* bv = bval ? bval + (size_t)run * bval_stride : nullptr;
    const float* bl = blap ? blap + (size_t)run * blap_stride : nullptr;
    __syncthreads();                 // the previous item is done with Wsm, red
    if (resident && run != staged) {
      for (int l = 1; l <= L - 2; ++l)
        stage_w(prm_r + net.w_off[l], net.dims[l], net.dims[l + 1], Wsm + (l - 1) * TILE);
      staged = run;
    }
    const float gamma = scal[2 * run], scale = scal[2 * run + 1];
    const float b_last = prm_r[net.b_off[L - 1]];
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;

    for (int tile = slot; tile < n_tiles; tile += S) {
      const int base = tile * T;
      __syncthreads();
      for (int i = threadIdx.x; i < T * D; i += NT) {
        const int r = i / D;
        xs[i] = (base + r < n) ? x[(size_t)base * D + i] : 0.f;
      }
      cp_async_wait_all();           // a new run's weights, staged above
      __syncthreads();
      forward_tile<D, BF16, true, WROWS>(X, xs, prm_r, net, ph.act, Wsm, !resident,
                                         nullptr);
      last_layer<D, BF16>(X, prm_r, net, outv);
      const int r = threadIdx.x;
      if (r < T && base + r < n) {
        const int g = base + r;
        const float v = outv[r] + b_last, lp = outv[(C - 1) * T + r];
        const float u = (bv ? bv[g] : 0.f) + scale * v;
        const float lap = (bl ? bl[g] : 0.f) + scale * lp;
        float nl, dnl;
        nonlin(ph, gamma, u, nl, dnl);
        const float hu = -ph.kinetic * lap + V[g] * u + nl;
        acc0 += hu * hu;
        acc1 += u * hu;
        acc2 += u * u;
        acc3 += u * u * w[g];
      }
    }
    __syncthreads();
    if (threadIdx.x < T) {
      red[threadIdx.x] = acc0;
      red[T + threadIdx.x] = acc1;
      red[2 * T + threadIdx.x] = acc2;
      red[3 * T + threadIdx.x] = acc3;
    }
    __syncthreads();
    if (threadIdx.x < 4) {
      float s = 0.f;
      for (int r = 0; r < T; ++r) s += red[threadIdx.x * T + r];
      partial[(size_t)item * 4 + threadIdx.x] = s;
    }
  }
}

template <int D, bool BF16, bool NARROW>
int launch(const float* x, const float* V, const float* w, const float* bval,
           int bval_stride, const float* blap, int blap_stride, const float* prm,
           const Net& net, const Phys& ph, const float* scal, int n, int R,
           int S, float* partial, int n_blocks, float* out, cudaStream_t stream) {
  const int n_gemm = net.n_layers - 2;
  const int resident = n_gemm <= 2;
  const size_t smem = (size_t)(NARROW ? 64 : MAXW) * LDS * sizeof(float) *
                      (1 + (resident ? (n_gemm > 0 ? n_gemm : 0) : 1));   // X, Wsm
  const auto kernel = sums_kernel<D, BF16, NARROW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && NARROW)  // room for two blocks' shared memory
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // n_blocks = min(R·S, SM count); two blocks an SM when NARROW
  const int grid = NARROW ? (R * S < 2 * n_blocks ? R * S : 2 * n_blocks) : n_blocks;
  kernel<<<grid, NT, smem, stream>>>(
      x, V, w, bval, bval_stride, blap, blap_stride, prm, net, ph, scal, n, R,
      S, resident, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<(R * 4 + 127) / 128, 128, 0, stream>>>(partial, S, R, 4, out);
  return (int)cudaGetLastError();
}

}  // namespace gpe

// Plain C entry point (ctypes). All pointers are device pointers except
// `dims` (host, n_layers + 1 ints). prm: R x n_params (run-major flat
// (W0, b0, W1, b1, ...) per run); scal: R x [gamma, scale]; bval/blap: null,
// or run r's n values at +r·stride (stride 0: one array shared by all runs).
// S: slots per run (min(SM count, tiles)); partial: R·S·4 floats of scratch;
// n_blocks: min(R·S, SM count), the grid (twice that, at most R·S, for a
// narrow f32 net: ≤ 2 hidden GEMM layers, hidden widths ≤ 64, two blocks an
// SM); out: R x 4 sums; bf16: 1 rounds every
// GEMM operand to bf16 (any R). Returns the CUDA error code of the
// launches (0 on success).
extern "C" int gpe_k1_sums_runs(const float* x, const float* V, const float* w,
                                const float* bval, int bval_stride,
                                const float* blap, int blap_stride,
                                const float* prm, const int* dims, int n_layers,
                                int n, int act, int nonlin, float p,
                                float kinetic, const float* scal, int R, int S,
                                float* partial, int n_blocks, float* out,
                                int bf16, void* stream) {
  using namespace gpe;
  if (R < 1 || S < 1 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Net net = make_net(dims, n_layers);
  const Phys ph{act, nonlin, p, kinetic};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool narrow = !bf16 && n_layers - 2 <= 2;
  for (int l = 1; l < n_layers; ++l) narrow = narrow && dims[l] <= 64;
#define GPE_K1_LAUNCH(D, B, NW) \
  launch<D, B, NW>(x, V, w, bval, bval_stride, blap, blap_stride, prm, net, ph, \
                   scal, n, R, S, partial, n_blocks, out, s)
  switch (dims[0] * 4 + (bf16 ? 1 : 0) + (narrow ? 2 : 0)) {
    case 4: return GPE_K1_LAUNCH(1, false, false);
    case 5: return GPE_K1_LAUNCH(1, true, false);
    case 6: return GPE_K1_LAUNCH(1, false, true);
    case 8: return GPE_K1_LAUNCH(2, false, false);
    case 9: return GPE_K1_LAUNCH(2, true, false);
    case 10: return GPE_K1_LAUNCH(2, false, true);
    case 12: return GPE_K1_LAUNCH(3, false, false);
    case 13: return GPE_K1_LAUNCH(3, true, false);
    case 14: return GPE_K1_LAUNCH(3, false, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GPE_K1_LAUNCH
}
