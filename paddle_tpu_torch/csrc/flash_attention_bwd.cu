// Flash-attention backward for Hopper (sm_90a), CUDA C++: the dQ kernel and
// the dK/dV kernel.
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// `_dq_kernel` (by `flash_attention_dq`) and `_dkv_kernel` (by
// `flash_attention_dkv`), both launched by `_bwd_impl` through pallas_call.
// With S = Q K^T, P = exp(scale * S - LSE) recomputed from the forward's
// log-sum-exp (masked entries exactly 0), dP = dO V^T and
// delta = rowsum(dO * O):
//
//   dS = P * (dP - delta)
//   dQ = scale * dS K          (dq_kernel: one CTA per 64 Q rows; it also
//                               computes delta and writes it out)
//   dK = scale * dS^T Q        (dkv_kernel: one CTA per 64 K rows; it reads
//   dV = P^T dO                 the delta that dq_kernel wrote)
//
// As in the TPU version each output row is owned by one CTA, so nothing
// needs atomics and the results are deterministic.  Masking is the
// forward's: column j is masked when j >= lens[b] (lens absent: Lk) and, when
// causal, when j > i in absolute top-left-aligned indices, also when
// Lq != Lk.  The mask applies before the exponential (a masked entry is
// exp2(-inf) = 0), so a fully masked row (LSE = -1e30) never forms
// exp(s + 1e30): its dQ is 0, and K/V rows that no query row sees get
// dK = dV = 0.
//
// Layout: q, o, dO [B, Lq, H*D], k/v [B, Lk, H*D], row-major and contiguous,
// 16-byte aligned; each head is a D-wide column slice read in place.  LSE
// and delta are [B, Lq, H] f32.  Nothing is padded in device memory: the
// copies zero-fill rows past Lq or Lk, and the kernels mask the rest.
//
// What bounds it on this card.  At the Transformer-base shape (B=16, H=8,
// L=256, D=64, f32, non-causal) dQ does three products (S again, dP, dQ),
// 6*B*H*L*L*D = 3.2 GFLOP, and moves q, k, v, o, dO, dQ, LSE and delta,
// 51 MB; dK/dV does four (S, dP, dV, dK), 4.3 GFLOP, and moves 51 MB.  f32
// products on the tensor cores are 3xTF32 (below), 165 TFLOP/s: 19.5 and
// 26 us of arithmetic against 15 us of traffic, so both are
// operation-bound (on the f32 FMA pipe, 67 TFLOP/s: 48 and 64 us).
//
// Design (the forward's, csrc/flash_attention_fwd.cu, whose note explains
// the split and the fragment layouts; both take their MMA and copy helpers
// from tf32_mma.cuh):
// - A CTA is 4 warps x 16 rows, one m16 tile of mma.sync.m16n8k8.tf32 each.
//   dq_kernel owns 64 Q rows and streams K/V tiles; dkv_kernel owns 64 K
//   rows and streams Q/dO tiles with their LSE and delta.  Grids
//   (ceil(Lq/64), H, B) and (ceil(Lk/64), H, B).  The resident 64-row tiles
//   (Q and dO; K and V) stay in shared memory and their A fragments are
//   re-read and split at each k-step, as the forward re-reads Q: held in
//   registers they would take 128 more a lane at D=64.
// - Streamed tiles of 64 rows (32 at D=128) go through two stages of
//   16-byte cp.async.cg copies, zero-filled past the end: tile n+1 loads
//   while tile n computes, one __syncthreads a tile.  Rows are padded by 16
//   bytes, so both fragment reads of a streamed tile, [n0+g][k0+t] for the
//   first products and [k0+2t(+1)][n0+g] for the last, hit 32 distinct
//   banks.  LSE and delta of a Q tile are strided by H in device memory and
//   come in by 4-byte cp.async.ca copies beside it.
// - Every product runs 3xTF32 with f32 accumulators: an f32 x splits into
//   TF32 big + small, and small*big + big*small + big*big keeps close to
//   f32 accuracy.  bf16 inputs are exact in TF32: S and dP take one MMA,
//   and the products whose A operand is the f32 P or dS take two.
// - dS (and P) go from the C layout of the first products to the A layout
//   of the last by the forward's k relabelling (logical t -> column 2t,
//   t+4 -> 2t+1): no data moves.
// - The tensor cores round an MMA's sum toward zero, so a chain of MMAs
//   into one accumulator over the whole loop drifts toward 0 (in the
//   forward such a chain failed the Transformer training step against the
//   CPU).  The streamed dimension is taken in groups of CHAIN = 4 k-steps
//   (32 rows or columns): each group's S and dP are computed, turned into
//   P and dS, and its MMAs into dQ (dK, dV) run into a fresh 4-register
//   partial per n-tile, added to the accumulator in f32 with
//   round-to-nearest.  A group holds its S and dP tiles (32 registers) and
//   its P or dS fragments (32) beside the accumulators: 32 a lane for dQ,
//   64 for dK + dV at D=64, 128 at D=128.
// - Masks are applied only on tiles that cross lens[b] or the causal
//   diagonal.  dq_kernel stops its K/V loop at min(lens, Lk) and, causal,
//   at its last row; dkv_kernel starts its Q loop at its first K row when
//   causal and skips it when all its K rows lie past lens.  Zero-filled Q
//   rows past Lq come with LSE = delta = 0 and contribute exactly 0.
// - delta: dq_kernel copies O into its second K/V stage before the loop
//   (free until the first tile there), and each lane sums dO * O over a
//   quarter of the columns of its two rows, then two quad shuffles; the
//   quad holds delta in the layout of its C fragments.  One lane of each
//   quad writes it for dkv_kernel, launched after dq_kernel on the same
//   stream.
// - Registers: the group loop is not unrolled (`#pragma unroll 1`); f32
//   dK/dV still takes 254-255 of the 255 a lane allows at D=64 and D=128,
//   dQ 190 and 242.  With 128 threads a CTA that allows 2 CTAs (8 warps)
//   an SM, as the shared memory does at D=64.
// What was tried (`profile_flash_bwd.py` builds each variant from this file
// and times it beside it; the numbers are in PERF.md): the group loop
// unrolled spills at f32 D=64 and is slower; 8 warps x 16 rows a CTA and
// 32-row streamed tiles at every D are slower too, since 255 registers a
// lane hold an SM to 8 warps either way; leaving the small part of the
// split unrounded (for the MMA to drop its low bits) is faster but rests
// on how the tensor cores read an f32 register as TF32, so the split stays
// the forward's.  No wgmma/TMA yet: later work, as for the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int BLOCK_M = 64;   // rows a CTA owns: Q rows (dQ) or K rows (dK/dV)
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = 32 * NUM_WARPS;
constexpr int WARP_ROWS = BLOCK_M / NUM_WARPS;  // one m16 MMA tile
constexpr int CHAIN = 4;      // k-steps of the last products per f32 partial
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int D>
struct Tile {
  static constexpr int BLOCK_N = D >= 128 ? 32 : 64;  // streamed rows a stage
  static constexpr int CHUNK = 16 / static_cast<int>(sizeof(T));  // per cp.async
  static constexpr int STRIDE = D + CHUNK;  // shared-memory row, 16 bytes of pad
  static constexpr int M_ELEMS = BLOCK_M * STRIDE;  // a resident tile
  static constexpr int N_ELEMS = BLOCK_N * STRIDE;  // a streamed tile
  // dq_kernel: two stages of K then V, then Q and dO; O sits in stage 1
  // before the loop
  static constexpr int DQ_SMEM = (4 * N_ELEMS + 2 * M_ELEMS) * static_cast<int>(sizeof(T));
  // dkv_kernel: two stages of Q, dO, LSE and delta, then K and V
  static constexpr int STAGE_BYTES =
      2 * N_ELEMS * static_cast<int>(sizeof(T)) + 2 * BLOCK_N * 4;
  static constexpr int DKV_SMEM = 2 * STAGE_BYTES + 2 * M_ELEMS * static_cast<int>(sizeof(T));
  static_assert(2 * N_ELEMS >= M_ELEMS, "O does not fit a K/V stage");
};

// B fragment of the first products from a row-major tile at p = &X[n0+g][k0+t]
// (B = X^T): b0 = X[n0+g][k0+t], b1 = X[n0+g][k0+t+4]
template <bool EXACT, typename T>
__device__ __forceinline__ void mma3_bt(float (&d)[4], const FragA& a, const T* p) {
  uint32_t b0, b0s, b1, b1s;
  split<EXACT>(widen(p[0]), b0, b0s);
  split<EXACT>(widen(p[4]), b1, b1s);
  mma3<EXACT, EXACT>(d, a, b0, b0s, b1, b1s);
}

// B fragment of the last products over the relabelled k index from a
// row-major tile at p = &X[k0+2t][n0+g] (B = X): b0 = X[k0+2t][n0+g],
// b1 = X[k0+2t+1][n0+g]; A (P or dS) is f32
template <bool EXACT, int STRIDE, typename T>
__device__ __forceinline__ void mma3_b(float (&d)[4], const FragA& a, const T* p) {
  uint32_t b0, b0s, b1, b1s;
  split<EXACT>(widen(p[0]), b0, b0s);
  split<EXACT>(widen(p[STRIDE]), b1, b1s);
  mma3<false, EXACT>(d, a, b0, b0s, b1, b1s);
}

// the A fragment of a k-step of the last products from a C fragment of the
// first (P or dS of one 8-wide slice), by the relabelling: a0 = c0 (column
// 2t), a1 = c2, a2 = c1 (column 2t+1), a3 = c3
__device__ __forceinline__ FragA c_to_a(const float (&c)[4]) {
  FragA f;
  split<false>(c[0], f.big[0], f.small[0]);
  split<false>(c[2], f.big[1], f.small[1]);
  split<false>(c[1], f.big[2], f.small[2]);
  split<false>(c[3], f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int src_size = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_size)
               : "memory");
}

// ROWS x D elements from global rows at src (row stride `stride` elements,
// row 0 valid) to shared rows at dst (stride Tile::STRIDE); rows at or past
// `valid_rows` are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride,
                                          int valid_rows) {
  using C = Tile<T, D>;
  constexpr int PER_ROW = D / C::CHUNK;
  static_assert(ROWS * PER_ROW % NUM_THREADS == 0, "uneven tile copy");
#pragma unroll
  for (int i = 0; i < ROWS * PER_ROW / NUM_THREADS; ++i) {
    const int idx = threadIdx.x + i * NUM_THREADS;
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * C::CHUNK;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * C::STRIDE + c, ok ? src + r * stride + c : src, ok);
  }
}

// ROWS f32 values of one head from [B, L, H] at src (stride H, row 0 valid)
// to dst; values at or past `valid_rows` are zero-filled
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int H,
                                         int valid_rows) {
  static_assert(ROWS <= NUM_THREADS, "one value a thread");
  const int r = threadIdx.x;
  if (r < ROWS) {
    const bool ok = r < valid_rows;
    cp_async4(dst + r, ok ? src + static_cast<long long>(r) * H : src, ok);
  }
}

// minBlocksPerSM 1, as the forward: ptxas then takes the registers it needs
template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const int* __restrict__ lens, T* __restrict__ dq,
              float* __restrict__ delta, int Lq, int Lk, int H, float scale,
              int causal) {
  using C = Tile<T, D>;
  constexpr int BLOCK_N = C::BLOCK_N;
  constexpr int STRIDE = C::STRIDE;
  constexpr int KS = D / 8;        // k-steps of S = Q K^T and dP = dO V^T
  constexpr int NT = BLOCK_N / 8;  // their n-tiles = k-steps of dQ += dS K
  constexpr int DT = D / 8;        // n-tiles of dQ
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  static_assert(NT % CHAIN == 0, "uneven dQ chain");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const stage0 = reinterpret_cast<T*>(smem_raw);
  T* const stage1 = stage0 + 2 * C::N_ELEMS;
  T* const qs = stage0 + 4 * C::N_ELEMS;
  T* const dos = qs + C::M_ELEMS;
  T* const os = stage1;  // O until delta is taken; K/V tiles after

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK_M;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // MMA group: rows g and g+8
  const int t = lane & 3;   // thread in group
  const int r0 = q0 + warp * WARP_ROWS;  // the warp's first query row
  const long long stride = static_cast<long long>(H) * D;
  const float scale_log2 = scale * LOG2E;

  // columns past kv_len are masked; a causal tile never looks past its
  // last row, so the K/V loop stops at kv_end
  const int kv_len = lens ? min(max(lens[b], 0), Lk) : Lk;
  const int kv_end = causal ? min(kv_len, q0 + BLOCK_M) : kv_len;

  const long long head = static_cast<long long>(h) * D;
  const long long qoff = (static_cast<long long>(b) * Lq + q0) * stride + head;
  const T* const kbase = k + static_cast<long long>(b) * Lk * stride + head;
  const T* const vbase = v + static_cast<long long>(b) * Lk * stride + head;
  // Q, dO and O, then the first K/V tile: two groups, so that delta is
  // taken while the tile is in flight
  load_rows<T, D, BLOCK_M>(qs, q + qoff, stride, Lq - q0);
  load_rows<T, D, BLOCK_M>(dos, dout + qoff, stride, Lq - q0);
  load_rows<T, D, BLOCK_M>(os, o + qoff, stride, Lq - q0);
  cp_async_commit();
  if (kv_end > 0) {
    load_rows<T, D, BLOCK_N>(stage0, kbase, stride, kv_end);
    load_rows<T, D, BLOCK_N>(stage0 + C::N_ELEMS, vbase, stride, kv_end);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const T* const qw = qs + warp * WARP_ROWS * STRIDE;
  const T* const dw = dos + warp * WARP_ROWS * STRIDE;

  // delta of rows g and g+8: this lane's quarter of the columns, then the
  // quad's sum (f32, as the plain version); rows past Lq are zero: 0
  float dl[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const T* const dor = dw + (g + 8 * r) * STRIDE;
    const T* const orow = os + (warp * WARP_ROWS + g + 8 * r) * STRIDE;
    float sum = 0.f;
#pragma unroll
    for (int c = t; c < D; c += 4) sum = fmaf(widen(dor[c]), widen(orow[c]), sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[r] = sum;
    const int row = r0 + g + 8 * r;
    lse2[r] = 0.f;
    if (row < Lq) {
      const long long rh = (static_cast<long long>(b) * Lq + row) * H + h;
      lse2[r] = lse[rh] * LOG2E;  // log2 units
      if (t == 0) delta[rh] = sum;
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int n = 0, k0 = 0; k0 < kv_end; ++n, k0 += BLOCK_N) {
    cp_async_wait<0>();
    // tile n is visible to every warp, and every warp is done with tile n-1
    // (with O, at n = 0), whose buffer the next load reuses
    __syncthreads();
    if (k0 + BLOCK_N < kv_end) {
      T* const next = (n & 1) ? stage0 : stage1;
      const long long off = static_cast<long long>(k0 + BLOCK_N) * stride;
      load_rows<T, D, BLOCK_N>(next, kbase + off, stride, kv_end - k0 - BLOCK_N);
      load_rows<T, D, BLOCK_N>(next + C::N_ELEMS, vbase + off, stride,
                               kv_end - k0 - BLOCK_N);
    }
    cp_async_commit();
    const T* const ks = (n & 1) ? stage1 : stage0;
    const T* const vs = ks + C::N_ELEMS;
    const bool edge = k0 + BLOCK_N > kv_len || (causal && k0 + BLOCK_N - 1 > r0);

#pragma unroll 1
    for (int j2 = 0; j2 < NT; j2 += CHAIN) {
      // S = Q K^T and dP = dO V^T for the group's CHAIN n-tiles
      float s[CHAIN][4], dp[CHAIN][4];
#pragma unroll
      for (int c = 0; c < CHAIN; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const FragA aq = load_a<T, STRIDE, EXACT>(qw + 8 * kk, g, t);
        const FragA ad = load_a<T, STRIDE, EXACT>(dw + 8 * kk, g, t);
#pragma unroll
        for (int c = 0; c < CHAIN; ++c) {
          const int off = (8 * (j2 + c) + g) * STRIDE + 8 * kk + t;
          mma3_bt<EXACT>(s[c], aq, ks + off);
          mma3_bt<EXACT>(dp[c], ad, vs + off);
        }
      }
      // P = exp2(S * scale * log2 e - LSE * log2 e), dS = P (dP - delta):
      // s[c][e] is row g + 8*(e>>1), column k0 + 8(j2+c) + 2t + (e&1)
      FragA ds[CHAIN];
#pragma unroll
      for (int c = 0; c < CHAIN; ++c) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float z = s[c][e] * scale_log2 - lse2[e >> 1];
          if (edge) {
            const int col = k0 + 8 * (j2 + c) + 2 * t + (e & 1);
            const int row = r0 + g + 8 * (e >> 1);
            if (col >= kv_len || (causal && col > row)) z = -INFINITY;
          }
          x[e] = exp2f(z) * (dp[c][e] - dl[e >> 1]);  // masked: exactly 0
        }
        ds[c] = c_to_a(x);
      }
      // dQ += dS K over the group's k-steps, into a fresh partial per n-tile
#pragma unroll
      for (int jd = 0; jd < DT; ++jd) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < CHAIN; ++c)
          mma3_b<EXACT, STRIDE>(part, ds[c],
                                ks + (8 * (j2 + c) + 2 * t) * STRIDE + 8 * jd + g);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jd][e] += part[e];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= Lq) continue;
    T* const dst = dq + (static_cast<long long>(b) * Lq + row) * stride + head + 2 * t;
#pragma unroll
    for (int jd = 0; jd < DT; ++jd)
      store2(dst + 8 * jd, acc[jd][2 * r] * scale, acc[jd][2 * r + 1] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS, 1)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ lens, T* __restrict__ dk,
               T* __restrict__ dv, int Lq, int Lk, int H, float scale,
               int causal) {
  using C = Tile<T, D>;
  constexpr int BLOCK_N = C::BLOCK_N;
  constexpr int STRIDE = C::STRIDE;
  constexpr int KS = D / 8;        // k-steps of S^T = K Q^T and dP^T = V dO^T
  constexpr int NT = BLOCK_N / 8;  // their n-tiles = k-steps of dV, dK
  constexpr int DT = D / 8;        // n-tiles of dK and dV
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  static_assert(NT % CHAIN == 0, "uneven dK/dV chain");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ks = reinterpret_cast<T*>(smem_raw + 2 * C::STAGE_BYTES);
  T* const vs = ks + C::M_ELEMS;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k_start = blockIdx.x * BLOCK_M;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kr0 = k_start + warp * WARP_ROWS;  // the warp's first K row
  const long long stride = static_cast<long long>(H) * D;
  const float scale_log2 = scale * LOG2E;

  const int kv_len = lens ? min(max(lens[b], 0), Lk) : Lk;
  // no Q row before the tile's first K row sees it when causal; a tile
  // wholly past kv_len sees no Q row at all
  const int q_lo = causal ? k_start : 0;
  const int q_end = k_start < kv_len ? Lq : 0;

  const long long head = static_cast<long long>(h) * D;
  const long long koff = (static_cast<long long>(b) * Lk + k_start) * stride + head;
  const T* const qbase = q + static_cast<long long>(b) * Lq * stride + head;
  const T* const dobase = dout + static_cast<long long>(b) * Lq * stride + head;
  const float* const lbase = lse + static_cast<long long>(b) * Lq * H + h;
  const float* const dbase = delta + static_cast<long long>(b) * Lq * H + h;

  // stage s: Q tile, dO tile, LSE (natural log), delta
  auto stage_q = [&](int s) {
    return reinterpret_cast<T*>(smem_raw + s * C::STAGE_BYTES);
  };
  auto stage_vec = [&](int s) {
    return reinterpret_cast<float*>(smem_raw + s * C::STAGE_BYTES +
                                    2 * C::N_ELEMS * static_cast<int>(sizeof(T)));
  };
  auto load_stage = [&](int s, int qb) {
    T* const qd = stage_q(s);
    float* const vec = stage_vec(s);
    const long long off = static_cast<long long>(qb) * stride;
    load_rows<T, D, BLOCK_N>(qd, qbase + off, stride, Lq - qb);
    load_rows<T, D, BLOCK_N>(qd + C::N_ELEMS, dobase + off, stride, Lq - qb);
    load_vec<BLOCK_N>(vec, lbase + static_cast<long long>(qb) * H, H, Lq - qb);
    load_vec<BLOCK_N>(vec + BLOCK_N, dbase + static_cast<long long>(qb) * H, H,
                      Lq - qb);
  };

  load_rows<T, D, BLOCK_M>(ks, k + koff, stride, Lk - k_start);
  load_rows<T, D, BLOCK_M>(vs, v + koff, stride, Lk - k_start);
  if (q_lo < q_end) load_stage(0, q_lo);
  cp_async_commit();

  const T* const kw = ks + warp * WARP_ROWS * STRIDE;
  const T* const vw = vs + warp * WARP_ROWS * STRIDE;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int n = 0, qb = q_lo; qb < q_end; ++n, qb += BLOCK_N) {
    cp_async_wait<0>();
    // stage n is visible to every warp, and every warp is done with stage
    // n-1, whose buffer the next load reuses
    __syncthreads();
    if (qb + BLOCK_N < q_end) load_stage((n + 1) & 1, qb + BLOCK_N);
    cp_async_commit();
    const T* const qsm = stage_q(n & 1);
    const T* const dosm = qsm + C::N_ELEMS;
    const float* const lsm = stage_vec(n & 1);
    const float* const dsm = lsm + BLOCK_N;
    const bool edge = kr0 + WARP_ROWS > kv_len ||
                      (causal && kr0 + WARP_ROWS - 1 > qb);

#pragma unroll 1
    for (int j2 = 0; j2 < NT; j2 += CHAIN) {
      // S^T = K Q^T and dP^T = V dO^T for the group's CHAIN Q slices
      float s[CHAIN][4], dp[CHAIN][4];
#pragma unroll
      for (int c = 0; c < CHAIN; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const FragA ak = load_a<T, STRIDE, EXACT>(kw + 8 * kk, g, t);
        const FragA av = load_a<T, STRIDE, EXACT>(vw + 8 * kk, g, t);
#pragma unroll
        for (int c = 0; c < CHAIN; ++c) {
          const int off = (8 * (j2 + c) + g) * STRIDE + 8 * kk + t;
          mma3_bt<EXACT>(s[c], ak, qsm + off);
          mma3_bt<EXACT>(dp[c], av, dosm + off);
        }
      }
      // P^T = exp2(S^T * scale * log2 e - LSE[col] * log2 e) into s, and
      // dS^T = P^T (dP^T - delta[col]) into dp: s[c][e] is K row
      // g + 8*(e>>1), Q row qb + 8(j2+c) + 2t + (e&1)
#pragma unroll
      for (int c = 0; c < CHAIN; ++c) {
        const int col = 8 * (j2 + c) + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lsm + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dsm + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float z = s[c][e] * scale_log2 - ((e & 1) ? l2.y : l2.x) * LOG2E;
          if (edge) {
            const int krow = kr0 + g + 8 * (e >> 1);
            const int qrow = qb + col + (e & 1);
            if (krow >= kv_len || (causal && krow > qrow)) z = -INFINITY;
          }
          const float p = exp2f(z);  // masked: exactly 0
          s[c][e] = p;
          dp[c][e] = p * (dp[c][e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      // dV += P^T dO, then dK += dS^T Q, over the group's k-steps, each
      // n-tile into a fresh partial
      {
        FragA pa[CHAIN];
#pragma unroll
        for (int c = 0; c < CHAIN; ++c) pa[c] = c_to_a(s[c]);
#pragma unroll
        for (int jd = 0; jd < DT; ++jd) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < CHAIN; ++c)
            mma3_b<EXACT, STRIDE>(part, pa[c],
                                  dosm + (8 * (j2 + c) + 2 * t) * STRIDE + 8 * jd + g);
#pragma unroll
          for (int e = 0; e < 4; ++e) dva[jd][e] += part[e];
        }
      }
      {
        FragA da[CHAIN];
#pragma unroll
        for (int c = 0; c < CHAIN; ++c) da[c] = c_to_a(dp[c]);
#pragma unroll
        for (int jd = 0; jd < DT; ++jd) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < CHAIN; ++c)
            mma3_b<EXACT, STRIDE>(part, da[c],
                                  qsm + (8 * (j2 + c) + 2 * t) * STRIDE + 8 * jd + g);
#pragma unroll
          for (int e = 0; e < 4; ++e) dka[jd][e] += part[e];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int krow = kr0 + g + 8 * r;
    if (krow >= Lk) continue;
    const long long off = (static_cast<long long>(b) * Lk + krow) * stride + head + 2 * t;
#pragma unroll
    for (int jd = 0; jd < DT; ++jd) {
      store2(dk + off + 8 * jd, dka[jd][2 * r] * scale, dka[jd][2 * r + 1] * scale);
      store2(dv + off + 8 * jd, dva[jd][2 * r], dva[jd][2 * r + 1]);
    }
  }
}

// above 48 KB a CTA's dynamic shared memory has to be asked for, once for
// each device (one bit each) and kernel instantiation (`asked`)
template <typename Kernel>
int allow_smem(Kernel kernel, int smem, std::atomic<uint64_t>& asked) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(asked.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    asked.fetch_or(bit, std::memory_order_relaxed);
  }
  return 0;
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, const int* lens, void* dq,
              float* delta, int B, int Lq, int Lk, int H, float scale,
              int causal, cudaStream_t stream) {
  constexpr int smem = Tile<T, D>::DQ_SMEM;
  static std::atomic<uint64_t> asked{0};
  const int rc = allow_smem(dq_kernel<T, D>, smem, asked);
  if (rc) return rc;
  const dim3 grid((Lq + BLOCK_M - 1) / BLOCK_M, H, B);
  dq_kernel<T, D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, lens, static_cast<T*>(dq), delta, Lq,
      Lk, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* lens,
               void* dk, void* dv, int B, int Lq, int Lk, int H, float scale,
               int causal, cudaStream_t stream) {
  constexpr int smem = Tile<T, D>::DKV_SMEM;
  static std::atomic<uint64_t> asked{0};
  const int rc = allow_smem(dkv_kernel<T, D>, smem, asked);
  if (rc) return rc;
  const dim3 grid((Lk + BLOCK_M - 1) / BLOCK_M, H, B);
  dkv_kernel<T, D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      lens, static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, H, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

#define FA_BWD_SWITCH_D(D, CALL)                       \
  switch (D) {                                         \
    case 16: { constexpr int HD = 16; return CALL; }   \
    case 32: { constexpr int HD = 32; return CALL; }   \
    case 64: { constexpr int HD = 64; return CALL; }   \
    case 128: { constexpr int HD = 128; return CALL; } \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, const int* lens, void* dq,
                float* delta, int B, int Lq, int Lk, int H, int D, float scale,
                int causal, cudaStream_t s) {
  FA_BWD_SWITCH_D(D, (launch_dq<T, HD>(q, k, v, o, dout, lse, lens, dq, delta,
                                       B, Lq, Lk, H, scale, causal, s)));
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const int* lens, void* dk, void* dv, int B, int Lq, int Lk,
                 int H, int D, float scale, int causal, cudaStream_t s) {
  FA_BWD_SWITCH_D(D, (launch_dkv<T, HD>(q, k, v, dout, lse, delta, lens, dk,
                                        dv, B, Lq, Lk, H, scale, causal, s)));
}

}  // namespace

// Plain C entry points, bound with ctypes.  Pointers are device pointers of
// contiguous tensors, 16-byte aligned; `lens` may be null.  dtype:
// 0 = float32, 1 = bfloat16 (q, k, v, o, dout and dq, dk, dv; lse and delta
// are always float32).  Each launches on `stream` and returns
// cudaGetLastError() (0 on success).
//
// flash_attention_dq writes dq and delta = rowsum(dout * o), [B, Lq, H];
// flash_attention_dkv reads that delta, so it is launched after
// flash_attention_dq on the same stream.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, const void* lens, void* dq,
                                  void* delta, int B, int Lq, int Lk, int H,
                                  int D, float scale, int causal, int dtype,
                                  void* stream) {
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int* n = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq<float>(q, k, v, o, dout, l, n, dq, dl, B, Lq, Lk, H, D, scale, causal, s);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(q, k, v, o, dout, l, n, dq, dl, B, Lq, Lk, H, D, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* lens, void* dk, void* dv,
                                   int B, int Lq, int Lk, int H, int D,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* n = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dkv<float>(q, k, v, dout, l, dl, n, dk, dv, B, Lq, Lk, H, D, scale, causal, s);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, l, dl, n, dk, dv, B, Lq, Lk, H, D, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
