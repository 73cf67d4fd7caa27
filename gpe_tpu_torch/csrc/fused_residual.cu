// K1 — fused GPE collocation sums on Hopper.
//
// Replaces: gpe_tpu/pallas/fused_residual.py, make_pallas_loss_eval →
// collocation_sums (the Pallas `kernel`). Per tile of points it runs the
// whole forward-Laplacian MLP (value, d Jacobian rows, Laplacian through
// every layer), forms u = base + s·net, Δu = base_lap + s·Δnet,
// Hu = −c·Δu + V·u + γ𝒩(u), and sums S = (Σ(Hu)², Σu·Hu, Σu², Σu²w).
//
// Bound on this card: operations. The hidden layers are (C·T=128) x 128 x 128
// f32 GEMMs per tile, ~0.26 MFLOP per point against ~24 bytes of input per
// point, far above the f32 CUDA-core ridge (~20 FLOP/B). f32 is kept for
// parity (no TF32 tensor cores), so the bound is the 67 TFLOP/s FFMA peak.
//
// Design: one persistent block of 256 threads per SM (grid = P blocks). The
// tile's channel state stays in shared memory across layers (never in HBM);
// when the net has ≤ 2 hidden 128x128 layers their weights are loaded into
// shared memory once per block (~200 KB with the state tile), otherwise they
// are streamed per layer. GEMMs are register-tiled 8x8 per thread on FFMA.
// Blocks run in no order, so block b walks tiles b, b+P, ... and writes its
// four partial sums to its own slice partial[b*4..]; a second launch sums the
// P slices in a fixed order (in double) — deterministic from run to run.
// Ragged edge: points past n load x = 0 and are masked out of the sums (a
// padded point's u(0) ≠ 0 must not contribute).
#include "common.cuh"

namespace gpe {

template <int D>
__global__ void __launch_bounds__(NT, 1)
sums_kernel(const float* __restrict__ x, const float* __restrict__ V,
            const float* __restrict__ w, const float* __restrict__ bval,
            const float* __restrict__ blap, const float* __restrict__ prm,
            Net net, Phys ph, const float* __restrict__ scal, int n,
            int resident, float* __restrict__ partial) {
  constexpr int C = D + 2, T = MAXW / C;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* Wsm = X + TILE_FLOATS;
  __shared__ float xs[T * D];
  __shared__ float outv[MAXW];
  __shared__ float red[4 * T];

  const int L = net.n_layers;
  for (int i = threadIdx.x; i < TILE_FLOATS; i += NT) X[i] = 0.f;
  if (resident)
    for (int l = 1; l <= L - 2; ++l)
      load_w(prm + net.w_off[l], net.dims[l], net.dims[l + 1],
             Wsm + (l - 1) * TILE_FLOATS, false);
  const float gamma = scal[0], scale = scal[1];
  const float b_last = prm[net.b_off[L - 1]];
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;

  const int n_tiles = (n + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    __syncthreads();
    for (int i = threadIdx.x; i < T * D; i += NT) {
      const int r = i / D;
      xs[i] = (base + r < n) ? x[(size_t)base * D + i] : 0.f;
    }
    __syncthreads();
    forward_tile<D>(X, xs, prm, net, ph.act, Wsm, !resident, nullptr);
    last_layer<D>(X, prm, net, outv);
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
    partial[blockIdx.x * 4 + threadIdx.x] = s;
  }
}

__global__ void reduce_partials(const float* __restrict__ partial, int P, int len,
                                float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  double s = 0.0;
  for (int b = 0; b < P; ++b) s += partial[(size_t)b * len + j];
  out[j] = static_cast<float>(s);
}

template <int D>
int launch(const float* x, const float* V, const float* w, const float* bval,
           const float* blap, const float* prm, const Net& net, const Phys& ph,
           const float* scal, int n, float* partial, int n_blocks, float* out,
           cudaStream_t stream) {
  const int n_gemm = net.n_layers - 2;
  const int resident = n_gemm <= 2;
  const size_t smem = (size_t)TILE_FLOATS * sizeof(float) *
                      (1 + (resident ? (n_gemm > 0 ? n_gemm : 0) : 1));
  cudaError_t err = cudaFuncSetAttribute(
      sums_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sums_kernel<D><<<n_blocks, NT, smem, stream>>>(x, V, w, bval, blap, prm, net,
                                                 ph, scal, n, resident, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<1, 32, 0, stream>>>(partial, n_blocks, 4, out);
  return (int)cudaGetLastError();
}

}  // namespace gpe

// Plain C entry point (ctypes). All pointers are device pointers except
// `dims` (host, n_layers + 1 ints). scal = [gamma, scale] on the device.
// partial: n_blocks * 4 floats of scratch; out: the 4 sums. Returns the CUDA
// error code of the launches (0 on success).
extern "C" int gpe_k1_sums(const float* x, const float* V, const float* w,
                           const float* bval, const float* blap, const float* prm,
                           const int* dims, int n_layers, int n, int act,
                           int nonlin, float p, float kinetic, const float* scal,
                           float* partial, int n_blocks, float* out, void* stream) {
  using namespace gpe;
  const Net net = make_net(dims, n_layers);
  const Phys ph{act, nonlin, p, kinetic};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims[0]) {
    case 1: return launch<1>(x, V, w, bval, blap, prm, net, ph, scal, n, partial, n_blocks, out, s);
    case 2: return launch<2>(x, V, w, bval, blap, prm, net, ph, scal, n, partial, n_blocks, out, s);
    case 3: return launch<3>(x, V, w, bval, blap, prm, net, ph, scal, n, partial, n_blocks, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
