// K2 — fused GPE training gradient (recompute-and-reverse) on Hopper.
//
// Replaces: gpe_tpu/pallas/fused_grad.py, make_pallas_value_and_grad →
// collocation_grads (the Pallas `kernel`). The loss depends on the points
// only through S = (Σ(Hu)², Σu·Hu, Σu², Σu²w), so with the four scalar
// cotangents c = ∂L/∂S the parameter gradient is Σ_k c_k ∂S_k/∂θ. Per tile
// the kernel reruns the forward-Laplacian pass, forms the pointwise
// cotangents h̄u = 2c₀Hu + c₁u, ū = c₁Hu + 2c₂u + 2c₃wu + h̄u(V + γ𝒩′),
// l̄ = −c·h̄u, and reverses the chain (σ‴ rule) accumulating W̄, b̄ over all
// rows. It also emits this tile's share of S (the relaxed mode's sums).
//
// Bound on this card: operations. Per tile it runs 3 GEMMs per hidden
// 128-wide layer (forward, W̄ = Inᵀ·Z̄, backprop Z̄·Wᵀ), ~0.79 MFLOP per
// point, all f32 FFMA on CUDA cores (no TF32, for parity): bound by the
// 67 TFLOP/s f32 peak.
//
// Design:
// - One persistent block of 256 threads per SM; block b walks tiles
//   b, b+P, ... and does forward then reverse for each tile.
// - Stored forward state: each hidden layer's PRE-activation state (z, the
//   d Jacobian rows, the Laplacian; 128 x 128 f32 per layer per tile) goes to
//   a per-BLOCK global scratch slot, reused tile after tile — P x (L−1) x 64 KB,
//   ~26 MB at P = 132, which stays in the 50 MB L2. Shared memory holds three
//   128 x 128 work tiles (~200 KB): the state/cotangent tile, and two for the
//   W̄ GEMM operands (one doubles as the streamed weight tile). A 16-row
//   all-in-smem tile was the alternative; per-block scratch keeps the GEMMs
//   at 128 rows.
// - σ, σ′, σ″, σ‴ are recomputed from the stored z (tanhf/sincosf), not
//   recovered from a stored σ: exact, and costs one transcendental per unit.
// - Cross-block reduction: block b accumulates W̄, b̄ and S into its own
//   slice of partial[P][n_params + 4]; a second launch sums the P slices in
//   a fixed order (double) — deterministic, no atomics.
// - Ragged edge: points past n get zero cotangents and are masked out of S.
#include "common.cuh"

namespace gpe {

template <int D>
__global__ void __launch_bounds__(NT, 1)
grads_kernel(const float* __restrict__ x, const float* __restrict__ V,
             const float* __restrict__ w, const float* __restrict__ bval,
             const float* __restrict__ blap, const float* __restrict__ prm,
             Net net, Phys ph, const float* __restrict__ scal, int n,
             float* __restrict__ scratch, float* __restrict__ partial) {
  constexpr int C = D + 2, T = MAXW / C, M = C * T;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);   // state / cotangents, [unit][m]
  float* Y = X + TILE_FLOATS;                   // Z̄ as [m][unit]; weight tile
  float* Z = Y + TILE_FLOATS;                   // layer inputs as [m][unit]
  __shared__ float xs[T * D];
  __shared__ float outv[MAXW];
  __shared__ float vbar[T], lbar[T];
  __shared__ float red[4 * T];

  const int L = net.n_layers;
  const int len = net.n_params + 4;
  float* part = partial + (size_t)blockIdx.x * len;
  float* store = scratch + (size_t)blockIdx.x * (L - 1) * MAXW * MAXW;
  for (int i = threadIdx.x; i < len; i += NT) part[i] = 0.f;
  for (int i = threadIdx.x; i < 3 * TILE_FLOATS; i += NT) X[i] = 0.f;
  const float gamma = scal[0], scale = scal[1];
  const float c0 = scal[2], c1 = scal[3], c2 = scal[4], c3 = scal[5];
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
    forward_tile<D>(X, xs, prm, net, ph.act, Y, true, store);
    last_layer<D>(X, prm, net, outv);

    // ---- pointwise cotangents (and this tile's sums) ----------------------
    if (threadIdx.x < T) {
      const int r = threadIdx.x, g = base + r;
      float vb = 0.f, lb = 0.f;
      if (g < n) {
        const float v = outv[r] + b_last, lp = outv[(C - 1) * T + r];
        const float u = (bval ? bval[g] : 0.f) + scale * v;
        const float lap = (blap ? blap[g] : 0.f) + scale * lp;
        const float Vg = V[g], wg = w[g];
        float nl, dnl;
        nonlin(ph, gamma, u, nl, dnl);
        const float hu = -ph.kinetic * lap + Vg * u + nl;
        acc0 += hu * hu;
        acc1 += u * hu;
        acc2 += u * u;
        acc3 += u * u * wg;
        const float hu_bar = 2.f * c0 * hu + c1 * u;
        const float u_bar = c1 * hu + 2.f * c2 * u + 2.f * c3 * wg * u +
                            hu_bar * (Vg + dnl);
        vb = scale * u_bar;
        lb = scale * (-ph.kinetic * hu_bar);
      }
      vbar[r] = vb;
      lbar[r] = lb;
    }
    __syncthreads();

    // ---- last layer (linear, width 1): its input is X (layer L-2's output)
    {
      const int K = net.dims[L - 1];
      const float* Wl = prm + net.w_off[L - 1];
      for (int k = threadIdx.x; k < K; k += NT) {
        const float* xk = X + k * LDS;
        float s = 0.f;
        for (int r = 0; r < T; ++r)
          s += xk[r] * vbar[r] + xk[(C - 1) * T + r] * lbar[r];
        part[net.w_off[L - 1] + k] += s;
      }
      if (threadIdx.x == 0) {
        float s = 0.f;
        for (int r = 0; r < T; ++r) s += vbar[r];
        part[net.b_off[L - 1]] += s;
      }
      __syncthreads();
      // cotangents of layer L-2's output: value/Laplacian rows only
      for (int idx = threadIdx.x; idx < K * M; idx += NT) {
        const int k = idx / M, m = idx % M, c = m / T, r = m % T;
        X[k * LDS + m] = (c == 0) ? vbar[r] * Wl[k]
                         : (c == C - 1) ? lbar[r] * Wl[k] : 0.f;
      }
    }

    // ---- hidden layers, top down -------------------------------------------
    for (int l = L - 2; l >= 0; --l) {
      const int N = net.dims[l + 1];
      const float* pre = store + (size_t)l * MAXW * MAXW;
      __syncthreads();
      // (a) pre-activation cotangents Z̄ from the output cotangents in X:
      //     z̄ = σ′v̄ + σ″Σᵢjzᵢj̄ᵢ + (σ″lz + σ‴Σᵢjzᵢ²)l̄,  jz̄ᵢ = σ′j̄ᵢ + 2σ″jzᵢl̄,
      //     lz̄ = σ′l̄.  Written to X (in place, [unit][m]) and Y ([m][unit]).
      for (int idx = threadIdx.x; idx < N * T; idx += NT) {
        const int o = idx / T, r = idx % T;
        const float* so = pre + o * MAXW;
        float* xo = X + o * LDS;
        const float z = so[r], lz = so[(C - 1) * T + r];
        float jz[D], jb[D], g2 = 0.f, jj = 0.f;
        const float vb = xo[r], lb = xo[(C - 1) * T + r];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          jz[i] = so[(1 + i) * T + r];
          jb[i] = xo[(1 + i) * T + r];
          g2 = fmaf(jz[i], jz[i], g2);
          jj = fmaf(jz[i], jb[i], jj);
        }
        float s0, s1, s2, s3;
        act_quad(ph.act, z, s0, s1, s2, s3);
        const float zb = s1 * vb + s2 * jj + (s2 * lz + s3 * g2) * lb;
        xo[r] = zb;
        Y[r * LDS + o] = zb;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float jzb = s1 * jb[i] + 2.f * s2 * jz[i] * lb;
          xo[(1 + i) * T + r] = jzb;
          Y[((1 + i) * T + r) * LDS + o] = jzb;
        }
        const float lzb = s1 * lb;
        xo[(C - 1) * T + r] = lzb;
        Y[((C - 1) * T + r) * LDS + o] = lzb;
      }
      if (l == 0) {
        // layer 0: input = (x, identity Jacobian, zero Laplacian), so
        // W̄0[i][o] = Σ_r x_ri z̄_ro + Σ_r jz̄ᵢ_ro and b̄0[o] = Σ_r z̄_ro
        __syncthreads();
        for (int o = threadIdx.x; o < N; o += NT) {
          const float* xo = X + o * LDS;
          float db = 0.f, dw[D];
#pragma unroll
          for (int i = 0; i < D; ++i) dw[i] = 0.f;
          for (int r = 0; r < T; ++r) {
            const float zb = xo[r];
            db += zb;
#pragma unroll
            for (int i = 0; i < D; ++i)
              dw[i] += xs[r * D + i] * zb + xo[(1 + i) * T + r];
          }
#pragma unroll
          for (int i = 0; i < D; ++i) part[net.w_off[0] + i * N + o] += dw[i];
          part[net.b_off[0] + o] += db;
        }
        break;
      }
      // (b) this layer's input = layer l-1's output, rebuilt from its stored
      //     pre-activation state, as Z[m][unit]
      {
        const int K = net.dims[l];
        const float* prev = store + (size_t)(l - 1) * MAXW * MAXW;
        for (int idx = threadIdx.x; idx < K * T; idx += NT) {
          const int k = idx / T, r = idx % T;
          const float* sk = prev + k * MAXW;
          const float z = sk[r], lz = sk[(C - 1) * T + r];
          float s0, s1, s2, s3;
          act_quad(ph.act, z, s0, s1, s2, s3);
          float g2 = 0.f;
#pragma unroll
          for (int i = 0; i < D; ++i) {
            const float jz = sk[(1 + i) * T + r];
            g2 = fmaf(jz, jz, g2);
            Z[((1 + i) * T + r) * LDS + k] = s1 * jz;
          }
          Z[r * LDS + k] = s0;
          Z[((C - 1) * T + r) * LDS + k] = s1 * lz + s2 * g2;
        }
      }
      __syncthreads();
      // (c) W̄_l[k][o] += Σ_m In[m][k] Z̄[m][o];  b̄_l[o] += Σ_r z̄[r][o]
      {
        const int K = net.dims[l];
        float acc[8][8];
        gemm_tile(Z, Y, M, acc);
        const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
        float* pw = part + net.w_off[l];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = frag(ti, i);
          if (k >= K) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int o = frag(tj, j);
            if (o < N) pw[k * N + o] += acc[i][j];
          }
        }
        for (int o = threadIdx.x; o < N; o += NT) {
          float s = 0.f;
          for (int r = 0; r < T; ++r) s += Y[r * LDS + o];
          part[net.b_off[l] + o] += s;
        }
      }
      __syncthreads();
      // (d) backprop to layer l-1's output: X[k][m] = Σ_o W[k][o] Z̄[o][m]
      load_w(prm + net.w_off[l], net.dims[l], N, Y, true);   // Y[o][k] = W[k][o]
      __syncthreads();
      {
        float acc[8][8];
        gemm_tile(Y, X, N, acc);
        __syncthreads();
        store_tile(X, acc);
      }
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
    part[net.n_params + threadIdx.x] = s;
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
           const float* scal, int n, float* scratch, float* partial,
           int n_blocks, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)3 * TILE_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      grads_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  grads_kernel<D><<<n_blocks, NT, smem, stream>>>(x, V, w, bval, blap, prm, net,
                                                  ph, scal, n, scratch, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = net.n_params + 4;
  reduce_partials<<<(len + 255) / 256, 256, 0, stream>>>(partial, n_blocks, len, out);
  return (int)cudaGetLastError();
}

}  // namespace gpe

// Plain C entry point (ctypes). Device pointers except `dims` (host).
// scal = [gamma, scale, c0, c1, c2, c3] on the device. scratch: n_blocks x
// (n_layers-1) x 128 x 128 floats; partial: n_blocks x (n_params + 4) floats;
// out: n_params gradient floats in the flat (W0, b0, W1, b1, ...) layout,
// then the 4 sums. Returns the CUDA error code of the launches.
extern "C" int gpe_k2_grads(const float* x, const float* V, const float* w,
                            const float* bval, const float* blap, const float* prm,
                            const int* dims, int n_layers, int n, int act,
                            int nonlin, float p, float kinetic, const float* scal,
                            float* scratch, float* partial, int n_blocks,
                            float* out, void* stream) {
  using namespace gpe;
  const Net net = make_net(dims, n_layers);
  const Phys ph{act, nonlin, p, kinetic};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims[0]) {
    case 1: return launch<1>(x, V, w, bval, blap, prm, net, ph, scal, n, scratch, partial, n_blocks, out, s);
    case 2: return launch<2>(x, V, w, bval, blap, prm, net, ph, scal, n, scratch, partial, n_blocks, out, s);
    case 3: return launch<3>(x, V, w, bval, blap, prm, net, ph, scal, n, scratch, partial, n_blocks, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
