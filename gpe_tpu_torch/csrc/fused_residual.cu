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
// Bound on this card: operations. The hidden layers are (C·T=128) x K x 128
// f32 GEMMs per tile, ~0.26 MFLOP per point at width 128 (~0.05 MFLOP at
// the 1D paper width 64) against ~24 bytes of input per point, far above
// the f32 CUDA-core ridge (~20 FLOP/B). f32 is kept for parity (no TF32
// tensor cores), so the bound is the 67 TFLOP/s FFMA peak.
//
// Design:
// - Run axis, not lane packing. The TPU packs M = 128/w narrow nets
//   block-diagonally into one 128-lane net because its lanes are fixed;
//   here each work item is (run, slot) and runs that run's own net with its
//   own γ, s and base arrays (run-major buffers, see common.cuh), so only
//   real weights are read and no zero off-diagonal block is multiplied.
//   One launch covers the whole ensemble; a run's sums are bit-equal to a
//   launch of that run alone (same tile walk, same fixed-order reduction).
// - Persistent blocks of 256 threads, at most one per SM (grid ≤ SM count),
//   walking the R·S items. The tile's channel state stays in shared memory
//   across layers (never in HBM); when the net has ≤ 2 hidden GEMM layers
//   the item's run's weights are loaded into shared memory once per item
//   (~200 KB with the state tile), otherwise they are streamed per layer.
//   GEMMs are register-tiled 8x8 per thread on FFMA.
// - Each item writes four partial sums to its own row; a second launch sums
//   each run's rows in a fixed order (in double) — deterministic.
// - Ragged edge: points past n load x = 0 and are masked out of the sums (a
//   padded point's u(0) ≠ 0 must not contribute).
// - compute_dtype = bf16 (template flag BF16, single runs; the run mode
//   stays f32 as in JAX): every GEMM operand is rounded to bf16 where it is
//   staged (common.cuh `op`), the FFMA products and sums stay f32. The f32
//   instantiation is the code it was before the flag.
#include "common.cuh"

namespace gpe {

template <int D, bool BF16>
__global__ void __launch_bounds__(NT, 1)
sums_kernel(const float* __restrict__ x, const float* __restrict__ V,
            const float* __restrict__ w, const float* __restrict__ bval,
            int bval_stride, const float* __restrict__ blap, int blap_stride,
            const float* __restrict__ prm, Net net, Phys ph,
            const float* __restrict__ scal, int n, int R, int S, int resident,
            float* __restrict__ partial) {
  constexpr int C = D + 2, T = MAXW / C;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* Wsm = X + TILE_FLOATS;
  __shared__ float xs[T * D];
  __shared__ float outv[MAXW];
  __shared__ float red[4 * T];

  const int L = net.n_layers;
  const int n_tiles = (n + T - 1) / T;
  for (int i = threadIdx.x; i < TILE_FLOATS; i += NT) X[i] = 0.f;
  for (int item = blockIdx.x; item < R * S; item += gridDim.x) {
    const int run = item / S, slot = item % S;
    const float* prm_r = prm + (size_t)run * net.n_params;
    const float* bv = bval ? bval + (size_t)run * bval_stride : nullptr;
    const float* bl = blap ? blap + (size_t)run * blap_stride : nullptr;
    __syncthreads();                 // the previous item is done with Wsm, red
    if (resident)
      for (int l = 1; l <= L - 2; ++l)
        load_w<BF16>(prm_r + net.w_off[l], net.dims[l], net.dims[l + 1],
                     Wsm + (l - 1) * TILE_FLOATS);
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
      __syncthreads();
      forward_tile<D, BF16>(X, xs, prm_r, net, ph.act, Wsm, !resident, nullptr);
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

template <int D, bool BF16>
int launch(const float* x, const float* V, const float* w, const float* bval,
           int bval_stride, const float* blap, int blap_stride, const float* prm,
           const Net& net, const Phys& ph, const float* scal, int n, int R,
           int S, float* partial, int n_blocks, float* out, cudaStream_t stream) {
  const int n_gemm = net.n_layers - 2;
  const int resident = n_gemm <= 2;
  const size_t smem = (size_t)TILE_FLOATS * sizeof(float) *
                      (1 + (resident ? (n_gemm > 0 ? n_gemm : 0) : 1));
  cudaError_t err = cudaFuncSetAttribute(
      sums_kernel<D, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sums_kernel<D, BF16><<<n_blocks, NT, smem, stream>>>(
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
// n_blocks: grid size (≤ SM count); out: R x 4 sums; bf16: 1 rounds every
// GEMM operand to bf16 (R = 1 only). Returns the CUDA error code of the
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
  if (R < 1 || S < 1 || n_blocks < 1 || (bf16 && R != 1))
    return (int)cudaErrorInvalidValue;
  const Net net = make_net(dims, n_layers);
  const Phys ph{act, nonlin, p, kinetic};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPE_K1_LAUNCH(D, B) \
  launch<D, B>(x, V, w, bval, bval_stride, blap, blap_stride, prm, net, ph, \
               scal, n, R, S, partial, n_blocks, out, s)
  switch (dims[0] * 2 + (bf16 ? 1 : 0)) {
    case 2: return GPE_K1_LAUNCH(1, false);
    case 3: return GPE_K1_LAUNCH(1, true);
    case 4: return GPE_K1_LAUNCH(2, false);
    case 5: return GPE_K1_LAUNCH(2, true);
    case 6: return GPE_K1_LAUNCH(3, false);
    case 7: return GPE_K1_LAUNCH(3, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GPE_K1_LAUNCH
}
