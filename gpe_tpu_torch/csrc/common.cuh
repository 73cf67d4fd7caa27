// Shared device code of the fused GPE kernels (fused_residual.cu, fused_grad.cu).
//
// Layout. A block owns a tile of T = 128 / C collocation points, C = d + 2
// channels (value, d Jacobian rows, Laplacian). The channel state of one
// layer is a 128 x 128 f32 tile in shared memory, X[unit][m] with
// m = c*T + r (channel c, point r of the tile) and a padded row stride LDS.
// Rows m >= C*T and units past a layer's width stay zero.
//
// GEMMs run on CUDA cores in f32 FFMA (tensor cores would mean TF32, ~3
// decimal digits, which breaks parity with the f32 reference). 256 threads
// each own an 8 x 8 register tile of the 128 x 128 output; operands are read
// from shared memory as float4, both "contraction-major":
//     C[i][j] = sum_q A[q*LDS + i] * B[q*LDS + j].
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace gpe {

constexpr int MAXW = 128;         // widest layer the kernels take
constexpr int LDS = 132;          // padded smem row stride (floats), 16 B aligned
constexpr int TILE_FLOATS = MAXW * LDS;
constexpr int NT = 256;           // threads per block
constexpr int MAX_LAYERS = 8;

struct Net {
  int n_layers;                   // number of (W, b) pairs
  int dims[MAX_LAYERS + 1];       // widths; dims[0] = d, dims[n_layers] = 1
  int w_off[MAX_LAYERS];          // offsets of W_l (dims[l] x dims[l+1], row
  int b_off[MAX_LAYERS];          // major) and b_l in the flat parameter buffer
  int n_params;
};

struct Phys {
  int act;                        // 0 tanh, 1 shifted_tanh, 2 sin
  int nonlin;                     // 0 abs_power: g|u|^(p-1)u, 1 power: g u^p
  float p, kinetic;
};

inline Net make_net(const int* dims, int n_layers) {
  Net net{};
  net.n_layers = n_layers;
  int off = 0;
  for (int l = 0; l <= n_layers; ++l) net.dims[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    net.w_off[l] = off;
    off += dims[l] * dims[l + 1];
    net.b_off[l] = off;
    off += dims[l + 1];
  }
  net.n_params = off;
  return net;
}

// sigma and its first three derivatives at the preactivation z (recomputed
// from z, never recovered from a stored sigma: shifted_tanh's sigma ~ 1..2
// would cost ~3 bits when t = sigma - 1 - eps is taken back out of it).
__device__ __forceinline__ void act_quad(int act, float z, float& s0, float& s1,
                                         float& s2, float& s3) {
  if (act == 2) {
    float s, c;
    sincosf(z, &s, &c);
    s0 = s; s1 = c; s2 = -s; s3 = -c;
    return;
  }
  const float t = tanhf(z);
  s1 = 1.f - t * t;
  s2 = -2.f * t * s1;
  s3 = (6.f * t * t - 2.f) * s1;
  s0 = (act == 1) ? (t + 1.f) + 1e-6f : t;
}

// gamma * N(u) and its derivative in u
__device__ __forceinline__ void nonlin(const Phys& ph, float gamma, float u,
                                       float& nl, float& dnl) {
  if (ph.nonlin == 1) {
    nl = gamma * powf(u, ph.p);
    dnl = gamma * ph.p * powf(u, ph.p - 1.f);
  } else {
    const float a = powf(fabsf(u), ph.p - 1.f);
    nl = gamma * a * u;
    dnl = gamma * ph.p * a;
  }
}

// Row/column index of entry e (0..7) of a thread's 8 x 8 fragment: two
// groups of 4 at 4*g and 64 + 4*g, so a warp's float4 loads of one operand
// row are contiguous (conflict-free).
__device__ __forceinline__ int frag(int g, int e) {
  return (e < 4) ? 4 * g + e : 64 + 4 * g + (e - 4);
}

// acc[i][j] = sum_{q < P} A[q*LDS + frag(ti, i)] * B[q*LDS + frag(tj, j)]
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A,
                                          const float* __restrict__ B, int P,
                                          float acc[8][8]) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float* a = A + 4 * ti;
  const float* b = B + 4 * tj;
#pragma unroll 2
  for (int q = 0; q < P; ++q) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + q * LDS);
    const float4 a1 = *reinterpret_cast<const float4*>(a + q * LDS + 64);
    const float4 b0 = *reinterpret_cast<const float4*>(b + q * LDS);
    const float4 b1 = *reinterpret_cast<const float4*>(b + q * LDS + 64);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// dst[i*LDS + j] = acc (the whole 128 x 128 tile, float4 stores)
__device__ __forceinline__ void store_tile(float* dst, const float acc[8][8]) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = dst + frag(ti, i) * LDS;
    *reinterpret_cast<float4*>(row + 4 * tj) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tj) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// W_l (K x N, row major, global) into a smem tile, zero-padded to 128 columns:
//   transpose = false: dst[k*LDS + o] = W[k][o]  (k < K)
//   transpose = true : dst[o*LDS + k] = W[k][o]  (o < N, k < 128)
__device__ __forceinline__ void load_w(const float* __restrict__ W, int K, int N,
                                       float* dst, bool transpose) {
  if (!transpose) {
    for (int idx = threadIdx.x; idx < K * MAXW; idx += NT) {
      const int k = idx / MAXW, o = idx % MAXW;
      dst[k * LDS + o] = (o < N) ? W[k * N + o] : 0.f;
    }
  } else {
    for (int idx = threadIdx.x; idx < N * MAXW; idx += NT) {
      const int k = idx / N, o = idx % N;    // consecutive threads: consecutive o
      dst[o * LDS + k] = (k < K) ? W[k * N + o] : 0.f;
    }
  }
}

// Forward-Laplacian pass of one tile through every layer but the last.
// On return X holds the last hidden layer's output state X[unit][m]. With
// `store` non-null, each hidden layer l's PRE-activation state (z with bias,
// Jacobian rows, Laplacian) is written to store[l*128*128 + unit*128 + m].
// W_l (l = 1..L-2) sits in the smem tile wbase + (l-1)*TILE_FLOATS when the
// weights are resident, or is loaded here into wbase when `stream` is set.
template <int D>
__device__ void forward_tile(float* X, const float* xs, const float* __restrict__ prm,
                             const Net& net, int act, float* wbase, bool stream,
                             float* __restrict__ store) {
  constexpr int C = D + 2, T = MAXW / C;
  const int L = net.n_layers;
  // layer 0: K = d contraction done directly; its Jacobian rows are W0's rows
  {
    const int N = net.dims[1];
    const float* W0 = prm + net.w_off[0];
    const float* b0 = prm + net.b_off[0];
    for (int idx = threadIdx.x; idx < N * T; idx += NT) {
      const int o = idx / T, r = idx % T;
      float z = 0.f, g2 = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float wi = W0[i * N + o];
        z = fmaf(xs[r * D + i], wi, z);
        g2 = fmaf(wi, wi, g2);
      }
      z += b0[o];
      float s0, s1, s2, s3;
      act_quad(act, z, s0, s1, s2, s3);
      float* xo = X + o * LDS;
      xo[r] = s0;
#pragma unroll
      for (int i = 0; i < D; ++i) xo[(1 + i) * T + r] = s1 * W0[i * N + o];
      xo[(C - 1) * T + r] = s2 * g2;
      if (store) {
        float* so = store + o * MAXW;
        so[r] = z;
#pragma unroll
        for (int i = 0; i < D; ++i) so[(1 + i) * T + r] = W0[i * N + o];
        so[(C - 1) * T + r] = 0.f;
      }
    }
  }
  for (int l = 1; l <= L - 2; ++l) {
    const int K = net.dims[l], N = net.dims[l + 1];
    float* Wl = stream ? wbase : wbase + (l - 1) * TILE_FLOATS;
    __syncthreads();
    if (stream) {
      load_w(prm + net.w_off[l], K, N, Wl, false);
      __syncthreads();
    }
    float acc[8][8];
    gemm_tile(Wl, X, K, acc);            // C[o][m] = sum_k W[k][o] X[k][m]
    __syncthreads();
    store_tile(X, acc);
    __syncthreads();
    const float* bl = prm + net.b_off[l];
    float* sl = store ? store + (size_t)l * MAXW * MAXW : nullptr;
    for (int idx = threadIdx.x; idx < N * T; idx += NT) {
      const int o = idx / T, r = idx % T;
      float* xo = X + o * LDS;
      const float z = xo[r] + bl[o];
      float jz[D], g2 = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        jz[i] = xo[(1 + i) * T + r];
        g2 = fmaf(jz[i], jz[i], g2);
      }
      const float lz = xo[(C - 1) * T + r];
      float s0, s1, s2, s3;
      act_quad(act, z, s0, s1, s2, s3);
      xo[r] = s0;
#pragma unroll
      for (int i = 0; i < D; ++i) xo[(1 + i) * T + r] = s1 * jz[i];
      xo[(C - 1) * T + r] = s1 * lz + s2 * g2;
      if (sl) {
        float* so = sl + o * MAXW;
        so[r] = z;
#pragma unroll
        for (int i = 0; i < D; ++i) so[(1 + i) * T + r] = jz[i];
        so[(C - 1) * T + r] = lz;
      }
    }
  }
  __syncthreads();
}

// Last (linear, width-1) layer: out[m] = sum_k X[k][m] W[k] for m < C*T.
template <int D>
__device__ __forceinline__ void last_layer(const float* X, const float* __restrict__ prm,
                                           const Net& net, float* outv) {
  constexpr int C = D + 2, T = MAXW / C;
  const int L = net.n_layers;
  const int K = net.dims[L - 1];
  const float* W = prm + net.w_off[L - 1];
  for (int m = threadIdx.x; m < C * T; m += NT) {
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(X[k * LDS + m], W[k], s);
    outv[m] = s;
  }
  __syncthreads();
}

}  // namespace gpe

extern "C" const char* gpe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
