// Shared device code of the fused GPE kernels (fused_residual.cu,
// fused_grad.cu, rowcat_eval.cu).
//
// Layout. A block owns a tile of T = 128 / C collocation points, C = d + 2
// channels (value, d Jacobian rows, Laplacian). The channel state of one
// layer is a 128 x 128 f32 tile in shared memory, X[unit][m] with
// m = c*T + r (channel c, point r of the tile) and a padded row stride LDS.
// Rows m >= C*T stay zero; units past a layer's width are zero or never
// read.
//
// GEMMs. Operands are read from shared memory "contraction-major":
//     C[i][j] = sum_q A[q*LDS + i] * B[q*LDS + j].
// gemm_tile runs them on CUDA cores in f32 FFMA, 256 threads each on an
// 8 x 8 register tile of the 128 x 128 output, float4 operand loads: f32
// K2's forward GEMMs. mma_gemm runs them on tensor cores in 3xTF32 (each
// operand split in two TF32 terms, three products, ~2^-21 relative per
// product; one TF32 product keeps ~3 decimal digits, which breaks parity
// with the f32 reference): f32 K2's reverse GEMMs, K1's f32 forward GEMMs
// (forward_tile's MMA flag) and K4's f32 GEMMs (64 x 64 warp blocks of its
// 128 x 256 output), so f32 parity holds at the TF32 rate over three. In
// the bf16 operand mode (template flag BF16) of K1 and K4 every GEMM operand —
// weights, channel state, layer 0's input x — is a bf16 value (nearest
// even): the state and x are rounded where they are written (`op`), the
// hidden weights by mma_gemm_bf16 as it packs its fragments (K4's padded
// copy arrives rounded from the host). mma_gemm_bf16 runs the hidden GEMMs
// on bf16 tensor cores (mma.sync m16n8k16, f32 accumulators): a bf16 x bf16
// product is exact in f32, so this is the TPU's bf16-MXU contract with f32
// accumulation, one product per term, no split. Biases, activations, the
// Hamiltonian and the sums stay f32. K2's bf16 mode rounds the activation
// operands only (forward_tile's RW = false): its weights stay f32, as the
// JAX kernel's bf16 x f32 products promote (fused_grad.cu). Its forward and
// backprop GEMMs run on mma_gemm_bf16x3: the f32 weight split into three
// bf16 terms that sum to it exactly, each multiplied by the bf16 operand on
// the same m16n8k16 instruction, so every product is exact in f32 and the
// result is the f32 product sum up to the order and rounding of its
// additions (per k16 slab on the tensor core, across slabs by FADD).
// Weights that a kernel stages more than once come from a copy padded to
// 128 columns (K4: the host's; K2: its layout kernel's), by cp.async; K1
// stages a run's weights once per block and run by 4-byte cp.async.
#pragma once
#include <cuda_bf16.h>
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

// A GEMM operand as staged: rounded to bf16 (nearest even) in the bf16 mode.
template <bool BF16>
__device__ __forceinline__ float op(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
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

// cp.async (16 B, global → shared, bypassing registers) and its fences.
__device__ __forceinline__ void cp_async16(float* smem_dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of a weight matrix padded to K rows x 128 columns (16 B
// aligned) into dst[k*LD + o] (LD a multiple of 4); it lands while the
// block does other work, and cp_async_wait_all() + a barrier make it visible.
template <int LD = LDS>
__device__ __forceinline__ void prefetch_w(const float4* __restrict__ Wp, int K,
                                           float* dst) {
  for (int i = threadIdx.x; i < K * (MAXW / 4); i += NT)
    cp_async16(dst + (i / (MAXW / 4)) * LD + 4 * (i % (MAXW / 4)), Wp + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Start the copy of W_l (K x N, row major, global; rows need no alignment)
// into dst[k*LDS + o], o < N, by 4-byte cp.async; columns past N are not
// written (the caller keeps them zero). cp_async_wait_all() + a barrier
// make it visible.
__device__ __forceinline__ void stage_w(const float* __restrict__ W, int K, int N,
                                        float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < K; k += NT / 32)        // a warp on a row, coalesced
    for (int o = lane; o < N; o += 32) cp_async4(dst + k * LDS + o, W + k * N + o);
  asm volatile("cp.async.commit_group;\n" ::);
}

// W_l (K x N, row major, global) into a smem tile, zero-padded to 128
// columns: dst[k*LDS + o] = W[k][o] (k < K). K1's streamed weights, f32 in
// both modes (the bf16 GEMM rounds them as it packs them).
__device__ __forceinline__ void load_w(const float* __restrict__ W, int K, int N,
                                       float* dst) {
  for (int idx = threadIdx.x; idx < K * MAXW; idx += NT) {
    const int k = idx / MAXW, o = idx % MAXW;
    dst[k * LDS + o] = (o < N) ? W[k * N + o] : 0.f;
  }
}

// a = hi + lo: hi is a rounded to TF32 (nearest, ties away: the bits of
// cvt.rna.tf32.f32 for finite a, which sm_90a emulates in a longer
// sequence; K2 times the same with either), lo = a − hi exactly, passed as
// is (the tensor core reads its top 19 bits).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d += a·b on one m16n8k8 TF32 tile, f32 accumulators
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A GEMM in 3xTF32 (K2's reverse GEMMs, K1's forward ones, K4's f32 ones),
// gemm_tile's operand convention with the row strides template parameters:
//   C[i][j] = Σ_{q < P} A[q·LDA + i]·B[q·LDB + j]  for i < rows, j < cols
// (P ≤ 128; entries past rows/cols are not read, or come out 0). With MT
// m16 tiles and NTL n8 tiles a warp (MT 4: 128 output rows; 2: the first
// 64, for rows ≤ 64; NTL 4: K1's and K2's 128 x 128 output, 8: K4's
// 128 x 256), warp w owns rows i0 = 16·MT(w & 1) .. +16·MT−1 and columns
// j0 = 8·NTL(w >> 1) .. +8·NTL−1; lane (g, t) holds acc[mt][nt] = C at
// rows i0 + 16mt + (g, g + 8) x columns j0 + 8nt + (2t, 2t + 1). Each
// output entry gets the same products in the same order whatever MT and
// NTL are. A warp whose block lies wholly past rows or cols skips the
// work; inside a block nothing is skipped, since a guard per m16n8 tile
// serialises the tensor-core instructions. Each k8 slab splits the MT A
// tiles once, then takes the n8 tiles one at a time: it splits that B
// tile and issues its MT hi·lo′ terms, then lo·hi′, then hi·hi′ (per
// accumulator the small products come first; adjacent mma.sync are
// independent). One B tile's split at a time keeps K4's 128 accumulators
// and A splits within the register budget of one block an SM. Lane (g, t)
// loads rows t and t + 4 at column g: with strides ≡ 8 (mod 32) floats
// (K4's) they fall on banks 8t + g, conflict-free; at ≡ 4 (K1's and K2's
// LDS) on 4t + g, two ways on 12 of the 20 banks.
template <int MT, int NTL = 4, int LDB = LDS, int LDA = LDS>
__device__ __forceinline__ void mma_gemm(const float* __restrict__ A,
                                         const float* __restrict__ B, int P,
                                         int rows, int cols, float (&acc)[MT][NTL][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = 16 * MT * (warp & 1), j0 = 8 * NTL * (warp >> 1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  if (i0 >= rows || j0 >= cols) return;
  const float* a = A + t * LDA + i0 + g;
  const float* b = B + t * LDB + j0 + g;
  for (int q0 = 0; q0 < P; q0 += 8) {
    const bool in0 = q0 + t < P, in1 = q0 + t + 4 < P;   // rows q0+t, q0+t+4
    const float* aq = a + q0 * LDA;
    const float* bq = b + q0 * LDB;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* p = aq + 16 * mt;
      split_tf32(in0 ? p[0] : 0.f, ah[mt][0], al[mt][0]);             // (g,   t)
      split_tf32(in0 ? p[8] : 0.f, ah[mt][1], al[mt][1]);             // (g+8, t)
      split_tf32(in1 ? p[4 * LDA] : 0.f, ah[mt][2], al[mt][2]);       // (g,   t+4)
      split_tf32(in1 ? p[4 * LDA + 8] : 0.f, ah[mt][3], al[mt][3]);   // (g+8, t+4)
    }
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const float* p = bq + 8 * nt;
      uint32_t bh[2], bl[2];
      split_tf32(in0 ? p[0] : 0.f, bh[0], bl[0]);                     // (k = t,   n = g)
      split_tf32(in1 ? p[4 * LDB] : 0.f, bh[1], bl[1]);               // (k = t+4, n = g)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][nt], ah[mt], bl);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][nt], al[mt], bh);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][nt], ah[mt], bh);
    }
  }
}

// Two f32 values as one bf16x2 register, lo in bits 0–15, each rounded to
// bf16 nearest even (cvt.rn.bf16x2.f32: the bits of op<true>)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a·b on one m16n8k16 bf16 tile, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A GEMM on bf16 tensor cores (the bf16 operand mode's hidden GEMMs, K1's
// and K4's), mma_gemm's operand convention, warp layout and accumulator
// layout, NTL n8 tiles a warp (4: K1's 32 columns; 8: K4's 64):
//   C[i][j] = Σ_{q < P} bf16(A[q·LDS + i])·bf16(B[q·LDB + j])
// for i < rows, j < cols, warp w on rows 16·MT(w & 1) .. +16·MT−1 and
// columns 8·NTL(w >> 1) .. +8·NTL−1. Operands are read as f32 and rounded
// as they are packed (a no-op for a value that is bf16 already); one
// m16n8k16 per tile and k16 slab, f32 accumulators, no split: the products
// are exact, only the order of the f32 sums differs from FFMA's. Per the
// PTX fragment map, lane (g, t)'s A register r of tile mt packs contraction
// rows (k, k+1) (r = 0, 1) or (k+8, k+9) (r = 2, 3), k = q0 + 2t, at column
// i0 + 16mt + g (+8 for r = 1, 3); its B register r rows (k, k+1) or
// (k+8, k+9) at column j0 + 8nt + g. With row strides ≡ 4 (mod 32) floats,
// rows 2t and 2t+1 fall on banks 8t + g and 8t + 4 + g: every load of a
// warp is conflict-free. Rows at or past P read 0 (every slab is guarded:
// the last partial slab split off was no faster, bf16_variants.py).
template <int MT, int NTL = 4, int LDB = LDS>
__device__ __forceinline__ void mma_gemm_bf16(const float* __restrict__ A,
                                              const float* __restrict__ B, int P,
                                              int rows, int cols,
                                              float (&acc)[MT][NTL][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = 16 * MT * (warp & 1), j0 = 8 * NTL * (warp >> 1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  if (i0 >= rows || j0 >= cols) return;
  const float* a = A + 2 * t * LDS + i0 + g;
  const float* b = B + 2 * t * LDB + j0 + g;
  for (int q0 = 0; q0 < P; q0 += 16) {
    const int k = q0 + 2 * t;
    const bool in0 = k < P, in1 = k + 1 < P, in8 = k + 8 < P, in9 = k + 9 < P;
    const float* aq = a + q0 * LDS;
    const float* bq = b + q0 * LDB;
    uint32_t af[MT][4], bf[NTL][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* p = aq + 16 * mt;
      af[mt][0] = pack_bf16(in0 ? p[0] : 0.f, in1 ? p[LDS] : 0.f);
      af[mt][1] = pack_bf16(in0 ? p[8] : 0.f, in1 ? p[LDS + 8] : 0.f);
      af[mt][2] = pack_bf16(in8 ? p[8 * LDS] : 0.f, in9 ? p[9 * LDS] : 0.f);
      af[mt][3] = pack_bf16(in8 ? p[8 * LDS + 8] : 0.f, in9 ? p[9 * LDS + 8] : 0.f);
    }
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const float* p = bq + 8 * nt;
      bf[nt][0] = pack_bf16(in0 ? p[0] : 0.f, in1 ? p[LDB] : 0.f);
      bf[nt][1] = pack_bf16(in8 ? p[8 * LDB] : 0.f, in9 ? p[9 * LDB] : 0.f);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
  }
}

// v0, v1 (f32) as three bf16x2 registers hi, mid, lo (v0 in bits 0–15):
// hi = bf16(v), mid = bf16(v − hi), lo = bf16(v − hi − mid), each nearest
// even. Each residual is exact in f32: v − hi has at most 16 significant
// bits and v − hi − mid at most 8, so lo is exact too and hi + mid + lo = v
// (for |v| ≥ 2^-110 or so, where lo is still a normal bf16 value).
__device__ __forceinline__ void split_bf16x3(float v0, float v1, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  v0 -= __uint_as_float(hi << 16);
  v1 -= __uint_as_float(hi & 0xffff0000u);
  mid = pack_bf16(v0, v1);
  v0 -= __uint_as_float(mid << 16);
  v1 -= __uint_as_float(mid & 0xffff0000u);
  lo = pack_bf16(v0, v1);
}

// A GEMM of an f32 A by a B whose values are bf16 already, on bf16 tensor
// cores at f32 accuracy (K2's bf16 mode: the weights times the rounded
// state in the forward, Wᵀ times the rounded Z̄ in the backprop).
// mma_gemm_bf16's operand convention, warp layout, fragment map and guards:
//   C[i][j] = Σ_{q < P} A[q·LDS + i]·B[q·LDB + j]  for i < rows, j < cols.
// Each k16 slab packs its NTL B tiles once (exact: the values are bf16),
// then takes the MT A tiles one at a time: splits the tile in registers as
// it is loaded (split_bf16x3; no shared-memory copy of the terms: K2's three
// f32 tiles leave no room) and issues lo·b, then mid·b, then hi·b for each
// n8 tile (the small terms first, as mma_gemm orders its TF32 terms; NTL
// independent mma.sync between dependent ones) into a slab sum that starts
// at zero, which one FADD adds into the accumulator. A bf16 x bf16 product
// is exact in f32, but the tensor core adds its products and its C input
// with truncation: chained through C over the whole contraction (24 mma.sync
// at K = 128) that bias shrinks every output by some units of its last
// place, and the bf16 rounding of the next layer's state turns it into flips
// that the gradient amplifies (k2_variants.py's mma_chain fails the x4 card
// test). Per slab the bias is relative to the slab's sum, and the FADD
// rounds to nearest. A warp whose block lies wholly past rows or cols skips
// it.
template <int MT, int NTL = 4, int LDB = LDS>
__device__ __forceinline__ void mma_gemm_bf16x3(const float* __restrict__ A,
                                                const float* __restrict__ B, int P,
                                                int rows, int cols,
                                                float (&acc)[MT][NTL][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = 16 * MT * (warp & 1), j0 = 8 * NTL * (warp >> 1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  if (i0 >= rows || j0 >= cols) return;
  const float* a = A + 2 * t * LDS + i0 + g;
  const float* b = B + 2 * t * LDB + j0 + g;
  for (int q0 = 0; q0 < P; q0 += 16) {
    const int k = q0 + 2 * t;
    const bool in0 = k < P, in1 = k + 1 < P, in8 = k + 8 < P, in9 = k + 9 < P;
    const float* aq = a + q0 * LDS;
    const float* bq = b + q0 * LDB;
    uint32_t bt[NTL][2];
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const float* p = bq + 8 * nt;
      bt[nt][0] = pack_bf16(in0 ? p[0] : 0.f, in1 ? p[LDB] : 0.f);
      bt[nt][1] = pack_bf16(in8 ? p[8 * LDB] : 0.f, in9 ? p[9 * LDB] : 0.f);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* p = aq + 16 * mt;
      uint32_t ah[4], am[4], al[4];
      split_bf16x3(in0 ? p[0] : 0.f, in1 ? p[LDS] : 0.f, ah[0], am[0], al[0]);
      split_bf16x3(in0 ? p[8] : 0.f, in1 ? p[LDS + 8] : 0.f, ah[1], am[1], al[1]);
      split_bf16x3(in8 ? p[8 * LDS] : 0.f, in9 ? p[9 * LDS] : 0.f, ah[2], am[2], al[2]);
      split_bf16x3(in8 ? p[8 * LDS + 8] : 0.f, in9 ? p[9 * LDS + 8] : 0.f, ah[3], am[3],
                   al[3]);
      float sl[NTL][4];
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sl[nt][e] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) mma_bf16(sl[nt], al, bt[nt]);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) mma_bf16(sl[nt], am, bt[nt]);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) mma_bf16(sl[nt], ah, bt[nt]);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += sl[nt][e];
    }
  }
}

// dst[i·LD + j] = mma_gemm's (or mma_gemm_bf16's) C: with NTL = 4, the
// whole 128 x 128 tile for MT = 4, its first 64 rows for MT = 2; K4's
// 128 x 256 with NTL = 8 (float2 stores)
template <int MT, int NTL, int LD = LDS>
__device__ __forceinline__ void mma_store(float* dst, const float (&acc)[MT][NTL][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = 16 * MT * (warp & 1) + g, j0 = 8 * NTL * (warp >> 1) + 2 * t;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      float* p = dst + (i0 + 16 * mt) * LD + j0 + 8 * nt;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * LD) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// X[i][j] ← Σ_{q < P} A[q·LDS + i]·X[q·LDS + j] by mma_gemm_bf16x3, i < rows
// (≤ 64: all 8 warps on 32 x 32 blocks, rows 64.. of X left as they were;
// else 64 x 32 blocks), j < cols; the barrier between the product and the
// store lets the output overwrite its operand. K2's bf16 forward and
// backprop GEMMs.
__device__ __forceinline__ void gemm_bf16x3_inplace(const float* A, float* X, int P,
                                                    int rows, int cols) {
  if (rows <= 64) {
    float acc[2][4][4];
    mma_gemm_bf16x3(A, X, P, rows, cols, acc);
    __syncthreads();
    mma_store(X, acc);
  } else {
    float acc[4][4][4];
    mma_gemm_bf16x3(A, X, P, rows, cols, acc);
    __syncthreads();
    mma_store(X, acc);
  }
}

// Forward-Laplacian pass of one tile through every layer but the last.
// On return X holds the last hidden layer's output state X[unit][m]. With
// `store` non-null, each hidden layer l's PRE-activation state (z with bias,
// Jacobian rows, Laplacian) is written to store[l*128*128 + unit*128 + m].
// W_l (l = 1..L-2) sits in the smem tile wbase + (l-1)*TILE_FLOATS when the
// weights are resident, or is loaded here into wbase when `stream` is set.
// BF16: the state written to X (the next GEMM's operand) and x are
// rounded, and with RW (round weights, the default) W0 too; K2 calls it
// with a `store` and RW = false, and then (MMA unset) its hidden GEMMs run
// on gemm_bf16x3_inplace, the f32 weights as three bf16 terms. MMA: the hidden
// GEMMs run on tensor cores, the output cut to the layer's width — in
// 3xTF32 (mma_gemm), or with BF16 on bf16 tensor cores (mma_gemm_bf16,
// which rounds the weights as it packs them) — instead of FFMA gemm_tile
// (K1 sets it, K2 does not). WROWS: the rows of a resident weight tile and
// of X — 64 when every hidden width is ≤ 64 (K1's narrow mode, MMA only),
// else 128.
template <int D, bool BF16 = false, bool MMA = false, int WROWS = MAXW, bool RW = BF16>
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
        const float wi = op<BF16 && RW>(W0[i * N + o]);
        z = fmaf(op<BF16>(xs[r * D + i]), wi, z);
        g2 = fmaf(wi, wi, g2);
      }
      z += b0[o];
      float s0, s1, s2, s3;
      act_quad(act, z, s0, s1, s2, s3);
      float* xo = X + o * LDS;
      xo[r] = op<BF16>(s0);
#pragma unroll
      for (int i = 0; i < D; ++i)
        xo[(1 + i) * T + r] = op<BF16>(s1 * op<BF16 && RW>(W0[i * N + o]));
      xo[(C - 1) * T + r] = op<BF16>(s2 * g2);
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
    float* Wl = stream ? wbase : wbase + (l - 1) * WROWS * LDS;
    __syncthreads();
    if (stream) {
      load_w(prm + net.w_off[l], K, N, Wl);
      __syncthreads();
    }
    if constexpr (MMA) {
      if (WROWS <= 64 || N <= 64) {      // all 8 warps on 32 x 32 blocks
        float acc[2][4][4];
        if constexpr (BF16) mma_gemm_bf16(Wl, X, K, N, C * T, acc);
        else mma_gemm(Wl, X, K, N, C * T, acc);
        __syncthreads();
        mma_store(X, acc);               // rows 64.. (past N) are never read
      } else {
        float acc[4][4][4];
        if constexpr (BF16) mma_gemm_bf16(Wl, X, K, N, C * T, acc);
        else mma_gemm(Wl, X, K, N, C * T, acc);
        __syncthreads();
        mma_store(X, acc);
      }
    } else if constexpr (BF16 && !RW) {  // K2: f32 weights as three bf16 terms
      gemm_bf16x3_inplace(Wl, X, K, N, C * T);
    } else {
      float acc[8][8];
      gemm_tile(Wl, X, K, acc);          // C[o][m] = sum_k W[k][o] X[k][m]
      __syncthreads();
      store_tile(X, acc);
    }
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
      xo[r] = op<BF16>(s0);
#pragma unroll
      for (int i = 0; i < D; ++i) xo[(1 + i) * T + r] = op<BF16>(s1 * jz[i]);
      xo[(C - 1) * T + r] = op<BF16>(s1 * lz + s2 * g2);
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

// Last (linear, width-1) layer: out[m] = sum_k X[k][m] W[k] for m < C*T
// (X is already rounded in the bf16 mode; W is rounded here).
template <int D, bool BF16 = false>
__device__ __forceinline__ void last_layer(const float* X, const float* __restrict__ prm,
                                           const Net& net, float* outv) {
  constexpr int C = D + 2, T = MAXW / C;
  const int L = net.n_layers;
  const int K = net.dims[L - 1];
  const float* W = prm + net.w_off[L - 1];
  for (int m = threadIdx.x; m < C * T; m += NT) {
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(X[k * LDS + m], op<BF16>(W[k]), s);
    outv[m] = s;
  }
  __syncthreads();
}

// Run axis (both kernels). A launch covers R independent nets of one
// architecture: run r's flat parameters at prm + r·n_params, its scalars at
// scal + r·n_scal, its base arrays at base + r·stride (stride 0: shared).
// Each run's tiles are split over S "slots" (S = min(SM count, tiles)); slot
// b of run r walks tiles b, b+S, … and writes its own partial row at item
// r·S + b. Blocks (persistent, at most one per SM) walk the items. The
// second pass sums each run's S rows in a fixed order, in double. The tile
// walk and the reduction order of a run do not depend on R, so a run's
// results are bit-equal to a launch with that run alone (R = 1).
__global__ void reduce_partials(const float* __restrict__ partial, int S, int R,
                                int len, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= R * len) return;
  const int run = j / len, k = j % len;
  const float* src = partial + (size_t)run * S * len + k;
  double s = 0.0;
  for (int b = 0; b < S; ++b) s += src[(size_t)b * len];
  out[j] = static_cast<float>(s);
}

}  // namespace gpe

extern "C" const char* gpe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
