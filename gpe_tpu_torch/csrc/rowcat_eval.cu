// K4 — channel-stacked ("rowcat") GPE collocation sums on Hopper.
//
// Replaces: gpe_tpu/pallas/rowcat_eval.py, make_rowcat_loss_eval →
// collocation_sums (the Pallas `kernel`). Same function as K1 at one run:
// the forward-Laplacian MLP (value, d Jacobian rows, Laplacian), then
// u = base + s·net, Hu = −c·Δu + V·u + γ𝒩(u) and
// S = (Σ(Hu)², Σu·Hu, Σu², Σu²w).
//
// Bound on this card: operations. Each hidden layer is one (C·2T = 256) x K
// x 128 GEMM per tile, ~0.16 MFLOP per point at the bench's width 100,
// against ~24 bytes of input per point: far above every ridge. f32 parity
// needs 3xTF32 on tensor cores (165 TFLOP/s, the roof chip_smoke.py holds
// K4 to), which the f32 mode runs; the bf16 operand mode runs one bf16
// tensor-core product per term (989 TFLOP/s dense).
//
// Design:
// - The TPU kernel stacks the C = d+2 channels into the rows of a
//   (C·tile, 128) VMEM scratch so each layer is one GEMM. K1 already has that
//   form on the card (a 128-row stacked tile, T = 128/C points). K4 stacks
//   twice the rows: a 256-row block of 2T points (64 points at d = 2), so each
//   weight element read from shared memory feeds twice the rows.
// - State X[unit][m] (128 units x 256 stacked rows, stride 264 floats in
//   f32, 260 in bf16: LDX) and one layer's weights W[k][o] (128 x 136 or
//   132: LDW) share 205 KB (f32) or 201 KB (bf16) of shared memory; a
//   ping-pong state pair like the TPU's st/st2 does not fit, so each GEMM
//   writes its output back into X in place after a barrier. Weights are
//   streamed per layer (kept resident when the net has one hidden GEMM
//   layer) from a copy the host pads to 128 columns (JAX's _pad_params): as
//   soon as a GEMM has read its weights, cp.async starts copying the next
//   layer's (or the next tile's first) into the same tile, so the copy lands
//   during the in-place store and the activation loop instead of stalling
//   the block between two barriers.
// - Hidden GEMMs on tensor cores (gemm_inplace): 64 x 64 warp blocks of the
//   128 x 256 output, 128 f32 accumulators a thread; in f32 3xTF32
//   (mma.sync m16n8k8, common.cuh mma_gemm), each B fragment split as it is
//   used so the accumulators and A's splits fit one block an SM. The f32
//   strides ≡ 8 (mod 32) keep its fragment loads conflict-free (3% faster
//   than ≡ 4 on an H100: k4_variants.py's stride4).
// - Layer 0 as the TPU kernel does it: v = x·W0 + b0, the Jacobian rows of
//   layer 0 are the rows of W0 — d small dots, no GEMM.
// - Persistent blocks (grid ≤ SM count) walk the tiles; each block writes
//   its four partial sums, a second launch (common.cuh reduce_partials) sums
//   them in a fixed order in double: deterministic. Points past n load x = 0
//   and are masked out of the sums.
// - BF16 (compute_dtype = bf16): every GEMM operand — weights, state, x — is
//   rounded to bf16 where it is staged (common.cuh `op`; the hidden weights'
//   padded copy arrives rounded from the host, cp.async copying it as is),
//   and the hidden GEMMs run on bf16 tensor cores (gemm_inplace<true>:
//   mma.sync m16n8k16, the f32 mode's warp blocks and write-back, f32
//   accumulators); products are exact, sums stay f32.
#include "common.cuh"

namespace gpe {

constexpr int ROWS4 = 256;             // stacked rows of one K4 tile
// Row strides (floats, 16 B aligned) of the state X and of the weight tile
// by operand mode, each conflict-free for its GEMM's fragment loads: ≡ 8
// (mod 32) in f32 (mma_gemm: rows t and t+4 at column g, banks 8t + g), ≡ 4
// in bf16 (mma_gemm_bf16: rows 2t and 2t+1, banks 8t + g and 8t + 4 + g).
template <bool BF16> constexpr int LDX = ROWS4 + (BF16 ? 4 : 8);
template <bool BF16> constexpr int LDW = MAXW + (BF16 ? 4 : 8);
static_assert(LDW<true> == LDS, "mma_gemm_bf16 reads the weight tile at LDS");

// X[o][m] = sum_{k < K} W[k*LW + o] * X[k*LX + m] for the 128 units o
// and 256 stacked rows m, on tensor cores into registers, then (after a
// barrier) written back into X. Warp w takes units 64(w & 1) .. +63 (MT =
// 4 m16 tiles) and rows 64(w >> 1) .. +63 (eight n8 tiles); a warp whose
// units all lie at or past the layer width N skips its GEMM, and units
// o ≥ N have zero weight columns, so their rows of X come out zero. Once
// every thread has read W, the copy of the next weights (next_w, next_k;
// none when null) starts into W's tile.
// f32: 3xTF32, common.cuh mma_gemm (f32 parity).
// BF16 (operands already bf16 values): bf16 tensor cores, mma_gemm_bf16.
template <bool BF16>
__device__ __forceinline__ void gemm_inplace(float* W, float* X, int K, int N,
                                             const float4* next_w, int next_k) {
  constexpr int LX = LDX<BF16>, LW = LDW<BF16>;
  float acc[4][8][4];
  if constexpr (BF16) mma_gemm_bf16<4, 8, LX>(W, X, K, N, ROWS4, acc);
  else mma_gemm<4, 8, LX, LW>(W, X, K, N, ROWS4, acc);
  __syncthreads();                     // every thread is done reading X and W
  if (next_w) prefetch_w<LW>(next_w, next_k, W);
  mma_store<4, 8, LX>(X, acc);
  __syncthreads();
}

template <int D, bool BF16>
__global__ void __launch_bounds__(NT, 1)
k4_kernel(const float* __restrict__ x, const float* __restrict__ V,
          const float* __restrict__ w, const float* __restrict__ bval,
          const float* __restrict__ blap, const float* __restrict__ prm,
          const float4* __restrict__ wpad, Net net, Phys ph,
          const float* __restrict__ scal, int n, float* __restrict__ partial) {
  constexpr int C = D + 2, T = 2 * (MAXW / C);         // points per tile
  constexpr int LX = LDX<BF16>;
  static_assert(C * T <= ROWS4, "stacked rows exceed the block");
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* Wsm = X + MAXW * LX;
  __shared__ float xs[T * D];
  __shared__ float outv[ROWS4];

  const int L = net.n_layers;
  const int n_gemm = L - 2;
  const int n_tiles = (n + T - 1) / T;
  const float gamma = scal[0], scale = scal[1];
  const float b_last = prm[net.b_off[L - 1]];
  const float* W0 = prm + net.w_off[0];
  const float* b0 = prm + net.b_off[0];
  const float* Wout = prm + net.w_off[L - 1];
  const int N0 = net.dims[1], KL = net.dims[L - 1];

  for (int i = threadIdx.x; i < MAXW * LX; i += NT) X[i] = 0.f;
  if (n_gemm > 0) prefetch_w<LDW<BF16>>(wpad, net.dims[1], Wsm);  // first tile's W_1
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    __syncthreads();                   // the previous tile is done with xs, X, outv
    for (int i = threadIdx.x; i < T * D; i += NT) {
      const int r = i / D;
      xs[i] = (base + r < n) ? op<BF16>(x[(size_t)base * D + i]) : 0.f;
    }
    __syncthreads();
    // layer 0: v = x·W0 + b0; Jacobian rows = rows of W0; Laplacian σ″·|W0|²
    for (int idx = threadIdx.x; idx < N0 * T; idx += NT) {
      const int o = idx / T, r = idx % T;
      float z = 0.f, g2 = 0.f, wv[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        wv[i] = op<BF16>(W0[i * N0 + o]);
        z = fmaf(xs[r * D + i], wv[i], z);
        g2 = fmaf(wv[i], wv[i], g2);
      }
      float s0, s1, s2, s3;
      act_quad(ph.act, z + b0[o], s0, s1, s2, s3);
      float* xo = X + o * LX;
      xo[r] = op<BF16>(s0);
#pragma unroll
      for (int i = 0; i < D; ++i) xo[(1 + i) * T + r] = op<BF16>(s1 * wv[i]);
      xo[(C - 1) * T + r] = op<BF16>(s2 * g2);
    }
    // hidden layers: one 256-row GEMM each, then the channel recursion;
    // W_l was prefetched during the previous layer (or tile), and the GEMM
    // starts the copy of the next one (W_1 again for the block's next tile)
    const float4* wl = wpad;
    for (int l = 1; l <= n_gemm; ++l) {
      const int K = net.dims[l], N = net.dims[l + 1];
      cp_async_wait_all();
      __syncthreads();                 // W_l landed for every thread; X written
      const bool last = l == n_gemm;
      const float4* next = last ? wpad : wl + K * (MAXW / 4);
      const bool more = !last || tile + (int)gridDim.x < n_tiles;
      gemm_inplace<BF16>(Wsm, X, K, N, (n_gemm > 1 && more) ? next : nullptr,
                         net.dims[last ? 1 : l + 1]);
      wl += K * (MAXW / 4);
      const float* bl = prm + net.b_off[l];
      for (int idx = threadIdx.x; idx < N * T; idx += NT) {
        const int o = idx / T, r = idx % T;
        float* xo = X + o * LX;
        const float z = xo[r] + bl[o];
        float jz[D], g2 = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          jz[i] = xo[(1 + i) * T + r];
          g2 = fmaf(jz[i], jz[i], g2);
        }
        const float lz = xo[(C - 1) * T + r];
        float s0, s1, s2, s3;
        act_quad(ph.act, z, s0, s1, s2, s3);
        xo[r] = op<BF16>(s0);
#pragma unroll
        for (int i = 0; i < D; ++i) xo[(1 + i) * T + r] = op<BF16>(s1 * jz[i]);
        xo[(C - 1) * T + r] = op<BF16>(s1 * lz + s2 * g2);
      }
    }
    __syncthreads();
    // output layer (width 1): out[m] = sum_k X[k][m] W[k]
    for (int m = threadIdx.x; m < C * T; m += NT) {
      float s = 0.f;
      for (int k = 0; k < KL; ++k) s = fmaf(X[k * LX + m], op<BF16>(Wout[k]), s);
      outv[m] = s;
    }
    __syncthreads();
    const int r = threadIdx.x;
    if (r < T && base + r < n) {
      const int g = base + r;
      const float v = outv[r] + b_last, lp = outv[(C - 1) * T + r];
      const float u = (bval ? bval[g] : 0.f) + scale * v;
      const float lap = (blap ? blap[g] : 0.f) + scale * lp;
      float nl, dnl;
      nonlin(ph, gamma, u, nl, dnl);
      const float hu = -ph.kinetic * lap + V[g] * u + nl;
      acc0 += hu * hu;
      acc1 += u * hu;
      acc2 += u * u;
      acc3 += u * u * w[g];
    }
  }
  // the block's partial sums: threads r < T hold them; reuse outv
  cp_async_wait_all();                 // no copy outlives the block
  __syncthreads();
  if (threadIdx.x < T) {
    outv[threadIdx.x] = acc0;
    outv[T + threadIdx.x] = acc1;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float s = 0.f;
    for (int r = 0; r < T; ++r) s += outv[threadIdx.x * T + r];
    partial[(size_t)blockIdx.x * 4 + threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x < T) {
    outv[threadIdx.x] = acc2;
    outv[T + threadIdx.x] = acc3;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float s = 0.f;
    for (int r = 0; r < T; ++r) s += outv[threadIdx.x * T + r];
    partial[(size_t)blockIdx.x * 4 + 2 + threadIdx.x] = s;
  }
}

template <int D, bool BF16>
int launch_k4(const float* x, const float* V, const float* w, const float* bval,
              const float* blap, const float* prm, const float4* wpad, const Net& net,
              const Phys& ph, const float* scal, int n, float* partial,
              int n_blocks, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)MAXW * (LDX<BF16> + LDW<BF16>) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      k4_kernel<D, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k4_kernel<D, BF16><<<n_blocks, NT, smem, stream>>>(x, V, w, bval, blap, prm,
                                                      wpad, net, ph, scal, n, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<1, 128, 0, stream>>>(partial, n_blocks, 1, 4, out);
  return (int)cudaGetLastError();
}

}  // namespace gpe

// Plain C entry point (ctypes). All pointers are device pointers except
// `dims` (host, n_layers + 1 ints; 1 ≤ d ≤ 3, hidden widths ≤ 128, at least
// one hidden layer, scalar output). prm: flat (W0, b0, W1, b1, ...);
// wpad: the hidden GEMM layers' W_1 .. W_{L-2}, each zero-padded to
// K_l x 128 and laid end to end (16 B aligned);
// scal: [gamma, scale]; bval/blap: null or n values; partial: n_blocks·4
// floats of scratch; n_blocks: grid size (≤ SM count, ≤ tiles); out: the 4
// sums; bf16: 1 rounds every GEMM operand to bf16. Returns the CUDA error
// code of the launches (0 on success).
extern "C" int gpe_k4_sums(const float* x, const float* V, const float* w,
                           const float* bval, const float* blap, const float* prm,
                           const float* wpad, const int* dims, int n_layers, int n, int act,
                           int nonlin, float p, float kinetic, const float* scal,
                           int bf16, float* partial, int n_blocks, float* out,
                           void* stream) {
  using namespace gpe;
  if (n_blocks < 1 || n_layers < 2 || n_layers > MAX_LAYERS || n < 1)
    return (int)cudaErrorInvalidValue;
  for (int l = 1; l < n_layers; ++l)
    if (dims[l] < 1 || dims[l] > MAXW) return (int)cudaErrorInvalidValue;
  const Net net = make_net(dims, n_layers);
  const Phys ph{act, nonlin, p, kinetic};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPE_K4_LAUNCH(D, B) \
  launch_k4<D, B>(x, V, w, bval, blap, prm, reinterpret_cast<const float4*>(wpad), \
                  net, ph, scal, n, partial, n_blocks, out, s)
  switch (dims[0] * 2 + (bf16 ? 1 : 0)) {
    case 2: return GPE_K4_LAUNCH(1, false);
    case 3: return GPE_K4_LAUNCH(1, true);
    case 4: return GPE_K4_LAUNCH(2, false);
    case 5: return GPE_K4_LAUNCH(2, true);
    case 6: return GPE_K4_LAUNCH(3, false);
    case 7: return GPE_K4_LAUNCH(3, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GPE_K4_LAUNCH
}
