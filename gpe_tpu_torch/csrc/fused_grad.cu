// K2 — fused GPE training gradient (recompute-and-reverse) on Hopper, for R
// independent runs (K3).
//
// Replaces: gpe_tpu/pallas/fused_grad.py, make_pallas_value_and_grad →
// collocation_grads (the Pallas `kernel`), with n_runs = 1 (K2) and its
// lane-packed n_runs = M > 1 mode (K3, contract in gpe_tpu/pallas/packing.py).
// The loss depends on the points only through S = (Σ(Hu)², Σu·Hu, Σu², Σu²w),
// so with the four scalar cotangents c = ∂L/∂S the parameter gradient is
// Σ_k c_k ∂S_k/∂θ. Per tile the kernel reruns the forward-Laplacian pass,
// forms the pointwise cotangents h̄u = 2c₀Hu + c₁u,
// ū = c₁Hu + 2c₂u + 2c₃wu + h̄u(V + γ𝒩′), l̄ = −c·h̄u, and reverses the chain
// (σ‴ rule) accumulating W̄, b̄ over all rows. It also emits this tile's share
// of S (the relaxed mode's sums). Every run has its own γ, s, c and bases.
//
// Bound on this card: operations. Per tile it runs 3 GEMMs per hidden GEMM
// layer, ~0.79 MFLOP per point at width 128 (~0.15 MFLOP at width 64): the
// forward product in f32 FFMA (common.cuh gemm_tile; K1's forward runs in
// 3xTF32 since its redesign, so K2's sums agree with K1's to f32 round-off,
// not to the bit), and the two reverse products, W̄ = Inᵀ·Z̄ and backprop
// Z̄·Wᵀ, on tensor cores in 3xTF32 (common.cuh mma_gemm). f32-parity
// products come no faster on this card than the dense TF32 rate over three
// (495/3 = 165 TFLOP/s): the roof chip_smoke.py holds K2 to. The bf16
// operand mode runs its forward and backprop products on bf16 tensor cores
// (three bf16 terms of each f32 weight) and W̄ in one bf16 product: 989/3
// and 989 TFLOP/s (chip_smoke.py's bound_k2_bf16).
//
// Design:
// - Run axis, not lane packing (see fused_residual.cu): work items are
//   (run, slot) pairs over run-major buffers (common.cuh); the kernel reads
//   only a run's real weights and writes only that run's gradient, so the
//   TPU's block masks hold by construction. A run's gradient and sums are
//   bit-equal to a launch of that run alone.
// - Persistent blocks of 256 threads, at most one per SM, walking the R·S
//   items; an item does forward then reverse for each of its tiles.
// - Stored forward state: each hidden layer's PRE-activation state (z, the
//   d Jacobian rows, the Laplacian; 128 x 128 f32 per layer per tile) goes to
//   a per-BLOCK global scratch slot, reused tile after tile and item after
//   item — G x (L−1) x 64 KB (G ≤ SM count, ~26 MB at 132), which stays in
//   the 50 MB L2. Shared memory holds three 128 x 128 work tiles (~200 KB):
//   X, the state/cotangent tile, and Y, Z for the GEMM operands (weights,
//   Z̄ as [m][unit], the layer input).
// - Weights: the layout kernel pad_weights writes, once per launch, every
//   run's hidden W_l as [k][128] and W_lᵀ as [o][128], zero-padded, into a
//   scratch buffer. grads_kernel stages them into Y or Z with 16 B cp.async
//   copies, issued as soon as that tile frees and waited for (wait_all +
//   barrier) only right before the GEMM that reads them: W₂ → Z after the
//   previous tile's last W̄ GEMM and W₁ → Y once its W̄ has left Y
//   (forward_tile reads W_l from Y + (l−1)·TILE); W_{L−2}ᵀ → Z right after
//   the forward pass; W_{l−1}ᵀ → Z right after layer l's W̄ GEMM. A net with
//   three or more hidden GEMM layers runs its own forward loop, alternating
//   Y and Z. Per hidden layer in reverse: (a) Z̄ into X (and Y as
//   [m][unit]); (d) backprop, reading Z = Wᵀ and X, writing X; (b) the layer
//   input, rebuilt from the stored state, into Z; (c) W̄, reading Z and Y,
//   then staged through Y so that the add into the item's partial row is
//   coalesced (a row of 32 consecutive units per warp access).
// - Reverse GEMMs (common.cuh mma_gemm): mma.sync m16n8k8 TF32 with f32
//   accumulators. Each f32 operand a splits into hi = a rounded to TF32 and
//   lo = a − hi; a product is hi·lo′ + lo·hi′ + hi·hi′, the small terms
//   first, lo·lo′ dropped: ~2⁻²¹ relative per product, against ~2⁻¹¹ for
//   one TF32 term.
//   8 warps, each a 64 x 32 block of the 128 x 128 output (4 x 4 m16n8
//   tiles, 64 f32 accumulators a thread, as gemm_tile's 8 x 8); a warp whose
//   block lies wholly past the layer's widths skips it, and contraction rows
//   past P read as zero. Fragment loads at LDS = 132 fall on banks
//   (4t + g) mod 32 (t = lane % 4, g = lane / 4): a 2-way conflict. LDS
//   stays 132 because forward_tile shares the tiles.
// - σ, σ′, σ″, σ‴ are recomputed from the stored z (tanhf/sincosf), not
//   recovered from a stored σ: exact, and costs one transcendental per unit.
// - Cross-block reduction: item (r, b) accumulates W̄, b̄ and S into its own
//   row of partial[R·S][n_params + 4] (R·S·(n_params + 4)·4 bytes, ~20 MB for
//   six width-64 runs at 96 slots); a second launch sums each run's S rows in
//   a fixed order (double) — deterministic, no atomics.
// - Ragged edge: points past n get zero cotangents and are masked out of S.
// - compute_dtype = bf16 (template flag BF16, single runs and the run axis):
//   the JAX kernel's `cast` of the activation operands, its weights f32
//   (fused_grad.py:205-208, 310-312, 332-334). Forward: x and the channel
//   state are rounded to bf16 as they are staged (common.cuh `op`); layer 0
//   (K = d) and the last layer keep f32 weights in FFMA, and the hidden GEMMs
//   run on bf16 tensor cores (common.cuh mma_gemm_bf16x3 through
//   gemm_bf16x3_inplace): each f32 weight splits, as its mma fragment is
//   loaded, into hi + mid + lo, three bf16 terms that sum to it exactly, and
//   each term times the bf16 state is exact in f32 — the sums of bf16
//   operands times f32 weights, in another order of f32 additions. Reverse:
//   Z̄ is rounded before the backprop GEMM, which runs on the same routine
//   (Wᵀ split, the rounded Z̄ packed as is): three m16n8k16 bf16 products
//   a k16 slab where 3xTF32 took six m16n8k8 ones, two of them on the zero
//   low part of a bf16 value. W̄ = bf16(In)ᵀ·bf16(Z̄) runs on bf16 tensor
//   cores (common.cuh mma_gemm_bf16, one product a term) with the f32
//   epilogue; layer 0's and the last layer's W̄ sums round the same
//   operands; b̄ sums the unrounded Z̄. Rows cut to the width: at width ≤ 64 all 8 warps take 32 x 32 blocks
//   of the 64 live rows (the FFMA forward paid for 128). No split is staged
//   in shared memory: the three f32 tiles leave no room for bf16 planes.
#include "common.cuh"

namespace gpe {

// Offsets (floats) inside one run's block of the padded-weight scratch:
// hidden layer l's W_l as [k][128] at f_off[l], W_lᵀ as [o][128] at t_off[l].
struct Pad {
  int f_off[MAX_LAYERS];
  int t_off[MAX_LAYERS];
  int per_run;
};

inline Pad make_pad(const Net& net) {
  Pad pad{};
  int off = 0;
  for (int l = 1; l <= net.n_layers - 2; ++l) {
    pad.f_off[l] = off;
    off += net.dims[l] * MAXW;
    pad.t_off[l] = off;
    off += net.dims[l + 1] * MAXW;
  }
  pad.per_run = off;
  return pad;
}

// The layout kernel: run r's W_l[k][o] to out[r·per_run + f_off[l] + k·128 + o]
// and to out[r·per_run + t_off[l] + o·128 + k], zeros past the widths.
__global__ void pad_weights(const float* __restrict__ prm_all, Net net, Pad pad,
                            int R, float* __restrict__ out) {
  const long total = (long)R * pad.per_run;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int run = (int)(i / pad.per_run), e = (int)(i % pad.per_run);
    int l = 1;
    while (l < net.n_layers - 2 && e >= pad.f_off[l + 1]) ++l;
    const int K = net.dims[l], N = net.dims[l + 1], c = e % MAXW;
    const float* W = prm_all + (size_t)run * net.n_params + net.w_off[l];
    float v;
    if (e < pad.t_off[l]) {
      const int k = (e - pad.f_off[l]) / MAXW;
      v = (c < N) ? W[k * N + c] : 0.f;
    } else {
      const int o = (e - pad.t_off[l]) / MAXW;
      v = (c < K) ? W[c * N + o] : 0.f;
    }
    out[i] = v;
  }
}

__device__ __forceinline__ const float4* padded(const float* wp, int off) {
  return reinterpret_cast<const float4*>(wp + off);
}

// The copy a tile's forward pass reads second, from run block wp, into Z:
// W₂, or W₁ᵀ when W₁ is the only hidden GEMM layer (its backprop reads it).
__device__ __forceinline__ void stage_second(const float* wp, const Net& net,
                                             const Pad& pad, float* Z) {
  if (net.n_layers == 3) prefetch_w(padded(wp, pad.t_off[1]), net.dims[2], Z);
  else prefetch_w(padded(wp, pad.f_off[2]), net.dims[2], Z);
}

// dst[k·N + o] += T[k·LDS + o] for k < K, o < N (a W̄ block into its
// partial row): a warp on 32 consecutive o of one row, so each access is
// coalesced; 16 loads in flight before their stores.
__device__ __forceinline__ void add_tile(float* __restrict__ dst, const float* T, int K,
                                         int N) {
  const int o = threadIdx.x & (MAXW - 1), k0 = threadIdx.x >> 7;   // 2 rows a pass
  if (o >= N) return;
  for (int k = k0; k < K; k += 32) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = (k + 2 * u < K) ? dst[(k + 2 * u) * N + o] : 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (k + 2 * u < K) dst[(k + 2 * u) * N + o] = v[u] + T[(k + 2 * u) * LDS + o];
  }
}

// forward_tile for a net of three or more hidden GEMM layers: the same
// arithmetic, W_l staged in Y (odd l) or Z (even l). W₁ and W₂ were started
// at the end of the previous tile; W_{l+2} starts once layer l's GEMM has
// read its tile.
template <int D, bool BF16>
__device__ void forward_deep(float* X, const float* xs, const float* __restrict__ prm,
                             const float* wp, const Net& net, const Pad& pad, int act,
                             float* Y, float* Z, float* __restrict__ store) {
  constexpr int C = D + 2, T = MAXW / C;
  const int L = net.n_layers;
  Net head = net;
  head.n_layers = 2;                     // forward_tile runs layer 0 alone
  forward_tile<D, BF16, false, MAXW, false>(X, xs, prm, head, act, Y, false, store);
  for (int l = 1; l <= L - 2; ++l) {
    const int K = net.dims[l], N = net.dims[l + 1];
    float* Wl = (l & 1) ? Y : Z;
    cp_async_wait_all();
    __syncthreads();
    if constexpr (BF16) {
      gemm_bf16x3_inplace(Wl, X, K, N, C * T);
      if (l + 2 <= L - 2) prefetch_w(padded(wp, pad.f_off[l + 2]), net.dims[l + 2], Wl);
    } else {
      float acc[8][8];
      gemm_tile(Wl, X, K, acc);
      __syncthreads();
      if (l + 2 <= L - 2) prefetch_w(padded(wp, pad.f_off[l + 2]), net.dims[l + 2], Wl);
      store_tile(X, acc);
    }
    __syncthreads();
    const float* bl = prm + net.b_off[l];
    float* sl = store + (size_t)l * MAXW * MAXW;
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
      xo[r] = op<BF16>(s0);
#pragma unroll
      for (int i = 0; i < D; ++i) xo[(1 + i) * T + r] = op<BF16>(s1 * jz[i]);
      xo[(C - 1) * T + r] = op<BF16>(s1 * lz + s2 * g2);
      float* so = sl + o * MAXW;
      so[r] = z;
#pragma unroll
      for (int i = 0; i < D; ++i) so[(1 + i) * T + r] = jz[i];
      so[(C - 1) * T + r] = lz;
    }
  }
  __syncthreads();
}

template <int D, bool BF16>
__global__ void __launch_bounds__(NT, 1)
grads_kernel(const float* __restrict__ x, const float* __restrict__ V,
             const float* __restrict__ w, const float* __restrict__ bval,
             int bval_stride, const float* __restrict__ blap, int blap_stride,
             const float* __restrict__ prm_all, const float* __restrict__ wpad,
             Net net, Pad pad, Phys ph, const float* __restrict__ scal, int n,
             int R, int S, float* __restrict__ scratch, float* __restrict__ partial) {
  constexpr int C = D + 2, T = MAXW / C, M = C * T;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);   // state / cotangents, [unit][m]
  float* Y = X + TILE_FLOATS;                   // weights; Z̄ as [m][unit]
  float* Z = Y + TILE_FLOATS;                   // weights; layer inputs as [m][unit]
  __shared__ float xs[T * D];
  __shared__ float outv[MAXW];
  __shared__ float vbar[T], lbar[T];
  __shared__ float red[4 * T];

  const int L = net.n_layers;
  const int len = net.n_params + 4;
  const int n_tiles = (n + T - 1) / T;
  float* store = scratch + (size_t)blockIdx.x * (L - 1) * MAXW * MAXW;
  for (int i = threadIdx.x; i < 3 * TILE_FLOATS; i += NT) X[i] = 0.f;
  __syncthreads();
  if (L >= 3) {                        // the first tile's weights
    const float* wp0 = wpad + (size_t)(blockIdx.x / S) * pad.per_run;
    prefetch_w(padded(wp0, pad.f_off[1]), net.dims[1], Y);
    stage_second(wp0, net, pad, Z);
  }
  for (int item = blockIdx.x; item < R * S; item += gridDim.x) {
    const int run = item / S, slot = item % S;
    const float* prm = prm_all + (size_t)run * net.n_params;
    const float* wp = wpad + (size_t)run * pad.per_run;
    const float* bv = bval ? bval + (size_t)run * bval_stride : nullptr;
    const float* bl = blap ? blap + (size_t)run * blap_stride : nullptr;
    float* part = partial + (size_t)item * len;
    __syncthreads();                   // the previous item is done with red
    for (int i = threadIdx.x; i < len; i += NT) part[i] = 0.f;
    const float* sc = scal + 6 * run;
    const float gamma = sc[0], scale = sc[1];
    const float c0 = sc[2], c1 = sc[3], c2 = sc[4], c3 = sc[5];
    const float b_last = prm[net.b_off[L - 1]];
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;

    for (int tile = slot; tile < n_tiles; tile += S) {
      const int base = tile * T;
      // the run of the block's next tile, whose weights this tile prefetches
      const int next_item = item + (int)gridDim.x;
      const int next_run = (tile + S < n_tiles) ? run
                           : (next_item < R * S) ? next_item / S : -1;
      __syncthreads();
      for (int i = threadIdx.x; i < T * D; i += NT) {
        const int r = i / D;
        xs[i] = (base + r < n) ? x[(size_t)base * D + i] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();                 // xs, and W₁, W₂ staged in Y, Z
      if (L <= 4) forward_tile<D, BF16, false, MAXW, false>(X, xs, prm, net, ph.act, Y,
                                                            false, store);
      else forward_deep<D, BF16>(X, xs, prm, wp, net, pad, ph.act, Y, Z, store);
      if (L >= 4) prefetch_w(padded(wp, pad.t_off[L - 2]), net.dims[L - 1], Z);
      last_layer<D>(X, prm, net, outv);

      // ---- pointwise cotangents (and this tile's sums) ----------------------
      if (threadIdx.x < T) {
        const int r = threadIdx.x, g = base + r;
        float vb = 0.f, lb = 0.f;
        if (g < n) {
          const float v = outv[r] + b_last, lp = outv[(C - 1) * T + r];
          const float u = (bv ? bv[g] : 0.f) + scale * v;
          const float lap = (bl ? bl[g] : 0.f) + scale * lp;
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

      // ---- last layer (linear, width 1): its input is X (layer L-2's output,
      //      rounded in the bf16 mode)
      {
        const int K = net.dims[L - 1];
        const float* Wl = prm + net.w_off[L - 1];
        for (int k = threadIdx.x; k < K; k += NT) {
          const float* xk = X + k * LDS;
          float s = 0.f;
          for (int r = 0; r < T; ++r)
            s += xk[r] * op<BF16>(vbar[r]) + xk[(C - 1) * T + r] * op<BF16>(lbar[r]);
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
          X[k * LDS + m] = (c == 0) ? op<BF16>(vbar[r]) * Wl[k]
                           : (c == C - 1) ? op<BF16>(lbar[r]) * Wl[k] : 0.f;
        }
      }

      // ---- hidden layers, top down -------------------------------------------
      for (int l = L - 2; l >= 0; --l) {
        const int N = net.dims[l + 1];
        const float* pre = store + (size_t)l * MAXW * MAXW;
        __syncthreads();
        if (l == 0 && L >= 3 && next_run >= 0)   // Y is free: the next tile's W₁
          prefetch_w(padded(wpad + (size_t)next_run * pad.per_run, pad.f_off[1]),
                     net.dims[1], Y);
        // (a) pre-activation cotangents Z̄ from the output cotangents in X:
        //     z̄ = σ′v̄ + σ″Σᵢjzᵢj̄ᵢ + (σ″lz + σ‴Σᵢjzᵢ²)l̄,  jz̄ᵢ = σ′j̄ᵢ + 2σ″jzᵢl̄,
        //     lz̄ = σ′l̄.  Written to X (in place, [unit][m]; above layer 0
        //     rounded in the bf16 mode, the backprop GEMM's operand) and,
        //     above layer 0, to Y ([m][unit], unrounded: b̄ sums it, the bf16
        //     W̄ GEMM rounds it; at layer 0 Y takes the next tile's W₁).
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
          const float lzb = s1 * lb;
          const bool rnd = BF16 && l > 0;
          xo[r] = rnd ? op<true>(zb) : zb;
          xo[(C - 1) * T + r] = rnd ? op<true>(lzb) : lzb;
          float jzb[D];
#pragma unroll
          for (int i = 0; i < D; ++i) {
            jzb[i] = s1 * jb[i] + 2.f * s2 * jz[i] * lb;
            xo[(1 + i) * T + r] = rnd ? op<true>(jzb[i]) : jzb[i];
          }
          if (l > 0) {
            Y[r * LDS + o] = zb;
#pragma unroll
            for (int i = 0; i < D; ++i) Y[((1 + i) * T + r) * LDS + o] = jzb[i];
            Y[((C - 1) * T + r) * LDS + o] = lzb;
          }
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
                dw[i] += op<BF16>(xs[r * D + i]) * op<BF16>(zb) + op<BF16>(xo[(1 + i) * T + r]);
            }
#pragma unroll
            for (int i = 0; i < D; ++i) part[net.w_off[0] + i * N + o] += dw[i];
            part[net.b_off[0] + o] += db;
          }
          break;
        }
        const int K = net.dims[l];
        cp_async_wait_all();
        __syncthreads();               // Z̄ in X and Y; W_lᵀ staged in Z
        // (d) backprop to layer l-1's output: X[k][m] = Σ_o W[k][o] Z̄[o][m]
        if constexpr (BF16) {
          gemm_bf16x3_inplace(Z, X, N, K, M);
        } else {
          float acc[4][4][4];
          mma_gemm(Z, X, N, K, M, acc);
          __syncthreads();
          mma_store(X, acc);
        }
        // (b) this layer's input = layer l-1's output, rebuilt from its stored
        //     pre-activation state, as Z[m][unit]
        {
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
          float acc[4][4][4];
          if constexpr (BF16) mma_gemm_bf16(Z, Y, M, K, N, acc);
          else mma_gemm(Z, Y, M, K, N, acc);
          for (int o = threadIdx.x; o < N; o += NT) {
            float s = 0.f;
            for (int r = 0; r < T; ++r) s += Y[r * LDS + o];
            part[net.b_off[l] + o] += s;
          }
          __syncthreads();             // Y and Z are free
          // Z takes the next weights at once; Y stages this tile's W̄ for a
          // coalesced add into the partial row (at layer 1, Y's copy of the
          // next tile's W₁ starts after the next barrier)
          if (l > 1) prefetch_w(padded(wp, pad.t_off[l - 1]), net.dims[l], Z);
          else if (next_run >= 0) stage_second(wpad + (size_t)next_run * pad.per_run,
                                               net, pad, Z);
          mma_store(Y, acc);
          __syncthreads();
          add_tile(part + net.w_off[l], Y, K, N);
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
  cp_async_wait_all();                 // no copy outlives the block
}

int launch_pad(const float* prm, const Net& net, const Pad& pad, int R, float* wpad,
               cudaStream_t stream) {
  const long total = (long)R * pad.per_run;
  if (total == 0) return 0;
  const long blocks = (total + 255) / 256;
  pad_weights<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(prm, net, pad,
                                                                      R, wpad);
  return (int)cudaGetLastError();
}

template <int D, bool BF16>
int launch(const float* x, const float* V, const float* w, const float* bval,
           int bval_stride, const float* blap, int blap_stride, const float* prm,
           const Net& net, const Phys& ph, const float* scal, int n, int R,
           int S, float* wpad, float* scratch, float* partial, int n_blocks,
           float* out, cudaStream_t stream) {
  const Pad pad = make_pad(net);
  int rc = launch_pad(prm, net, pad, R, wpad, stream);
  if (rc) return rc;
  const size_t smem = (size_t)3 * TILE_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      grads_kernel<D, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  grads_kernel<D, BF16><<<n_blocks, NT, smem, stream>>>(
      x, V, w, bval, bval_stride, blap, blap_stride, prm, wpad, net, pad, ph, scal,
      n, R, S, scratch, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = net.n_params + 4;
  reduce_partials<<<(R * len + 255) / 256, 256, 0, stream>>>(partial, S, R, len, out);
  return (int)cudaGetLastError();
}

}  // namespace gpe

// Plain C entry points (ctypes). Device pointers except `dims` (host).
// prm: R x n_params (run-major flat (W0, b0, W1, b1, ...) per run).
//
// gpe_k2_pad_weights: the layout kernel alone. wpad: R blocks, each the
// hidden GEMM layers l = 1..n_layers-2 in order, W_l as [dims[l]][128] then
// W_lᵀ as [dims[l+1]][128], zero-padded (R·Σ_l (dims[l] + dims[l+1])·128
// floats, 16 B aligned).
extern "C" int gpe_k2_pad_weights(const float* prm, const int* dims, int n_layers,
                                  int R, float* wpad, void* stream) {
  using namespace gpe;
  if (R < 1 || n_layers < 1 || n_layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  const Net net = make_net(dims, n_layers);
  return launch_pad(prm, net, make_pad(net), R, wpad, static_cast<cudaStream_t>(stream));
}

// gpe_k2_grads_runs: the layout kernel into wpad, then the gradient kernel
// and the reduction. scal: R x [gamma, scale, c0, c1, c2, c3]; bval/blap:
// null, or run r's n values at +r·stride (stride 0: shared). S: slots per
// run (min(SM count, tiles)); n_blocks: grid size (≤ SM count); scratch:
// n_blocks x (n_layers-1) x 128 x 128 floats; partial: R·S x (n_params + 4)
// floats; out: R rows of n_params gradient floats in the flat layout
// followed by the run's 4 sums; bf16: 1 for the bf16 operand mode (last, so
// that a build without it ignores it). Returns the CUDA error code of the
// launches.
extern "C" int gpe_k2_grads_runs(const float* x, const float* V, const float* w,
                                 const float* bval, int bval_stride,
                                 const float* blap, int blap_stride,
                                 const float* prm, const int* dims, int n_layers,
                                 int n, int act, int nonlin, float p,
                                 float kinetic, const float* scal, int R, int S,
                                 float* wpad, float* scratch, float* partial,
                                 int n_blocks, float* out, void* stream, int bf16) {
  using namespace gpe;
  if (R < 1 || S < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const Net net = make_net(dims, n_layers);
  const Phys ph{act, nonlin, p, kinetic};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPE_K2_LAUNCH(D, B)                                                          \
  launch<D, B>(x, V, w, bval, bval_stride, blap, blap_stride, prm, net, ph, scal, n, \
               R, S, wpad, scratch, partial, n_blocks, out, s)
  switch (dims[0] * 2 + (bf16 ? 1 : 0)) {
    case 2: return GPE_K2_LAUNCH(1, false);
    case 3: return GPE_K2_LAUNCH(1, true);
    case 4: return GPE_K2_LAUNCH(2, false);
    case 5: return GPE_K2_LAUNCH(2, true);
    case 6: return GPE_K2_LAUNCH(3, false);
    case 7: return GPE_K2_LAUNCH(3, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GPE_K2_LAUNCH
}
