// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_fwd_impl` through pallas_call).  Computes,
// per batch row b, head h and query row i:
//
//   O[b,i,h,:]  = softmax_j(scale * q_i . k_j)[masked] . V
//   LSE[b,i,h]  = m + log(l)            (f32, natural-log units)
//
// with column j masked when j >= lens[b] (lens absent: Lk) and, when causal,
// when j > i in absolute top-left-aligned indices.  A fully masked row yields
// O = 0 and LSE = -1e30, as the Pallas kernel does.
//
// Layout: q [B, Lq, H*D], k/v [B, Lk, H*D], row-major and contiguous; each
// head is a D-wide column slice read in place (no [B,H,L,D] transpose).
// LSE is [B, Lq, H].  The kernel masks the ragged edges of Lq and Lk itself;
// nothing is padded in device memory.
//
// What bounds it on this card.  At the Transformer-base shape
// (B=16, H=8, L=256, D=64) one non-causal call does 4*B*H*L*L*D = 2.1 GFLOP
// in its two products and moves q, k, v and O once: 34 MB in f32, 10 us at
// 3.35 TB/s.  On the FMA pipe (67 TFLOP/s f32) the products take 32 us, so a
// kernel without tensor cores is compute-bound.  The tensor cores take f32
// operands only as TF32 (10-bit mantissa), but an f32 value splits exactly
// into a TF32 "big" part and a TF32 "small" part, x ~ big + small (error
// near 2^-23 |x|), and the three TF32 products big*big + big*small +
// small*big keep close to f32 accuracy (CUTLASS's OpMultiplyAddFastF32).
// At 495 / 3 = 165 TFLOP/s the products take 13 us: the call stays
// operation-bound, 2.5x nearer its bytes than on the FMA pipe.
//
// Design.
// - A CTA of 4 warps covers 64 query rows of one (head, batch row); each
//   warp owns 16 rows, one m16 tile of mma.sync.m16n8k8.tf32.  Grid
//   (ceil(Lq/64), H, B).  Causal CTAs stop at their diagonal; K/V rows past
//   lens[b] are never loaded.
// - K/V tiles of 64 rows (32 at D=128) stream through shared memory in two
//   stages with 16-byte cp.async.cg copies: tile n+1 loads while tile n
//   computes, one __syncthreads per tile.  Rows past the end are zero-filled
//   by the copy's src-size operand, so no garbage (or NaN) enters a product.
//   bf16 stays bf16 in shared memory and widens as fragments are built.
// - Shared-memory rows are padded by 16 bytes (D+4 floats, D+8 bf16): the
//   fragment reads K[n0+g][k0+t] and V[k0+2t(+1)][n0+g] then fall on 32
//   distinct banks (bf16: distinct or shared 4-byte words).
// - Both products run 3xTF32 on the tensor cores with f32 accumulators.
//   bf16 fits TF32 exactly, so for bf16 the small part of Q, K and V is 0
//   and those MMAs are not emitted: Q K^T is one MMA, P V two.  The scale
//   (times log2 e) multiplies the scores after the first product rather
//   than Q before it, so that bf16 Q stays exact in TF32.
// - The tensor cores round an MMA's f32 sum toward zero, so a long chain
//   of MMAs into one accumulator drifts toward 0 (about an ulp per MMA).
//   O's chain would span the whole K loop: with it O's mean error was 7x
//   the FMA kernel's and the Transformer training step against the CPU
//   failed.  So every 4 k-steps of P V (12 MMAs) go into a fresh partial,
//   added to O in f32 with round-to-nearest.
// - Q stays in shared memory as a 64-row tile beside the two stages, and
//   its fragments are read and split again at each k-step.  Held in
//   registers for the whole K loop (64 more at f32 D=64), they made ptxas
//   spill at the 255-register limit at f32 D=64 and D=128.
// - Online softmax on the accumulator fragments: a lane holds rows g and
//   g+8 of its warp's 16; a row's max reduces over its quad with two xor
//   shuffles, exp2 runs once per score, the running sum stays per lane and
//   reduces once at the end.  Masks are applied only on tiles that cross
//   lens[b] or the causal diagonal.
// - P goes from the first product's C layout to the second's A layout with
//   no data movement: the second product sums over the 8 columns of each
//   k-step in any order, so its k index is relabelled (logical t -> column
//   2t, logical t+4 -> column 2t+1).  The lane's C registers (P[g][2t],
//   P[g][2t+1], P[g+8][2t], P[g+8][2t+1]) are then its A registers, and V's
//   B fragment reads rows 2t and 2t+1 of the k-step.  No shuffle, no shared
//   memory.
// - Epilogue: O = acc / l, stored as f32 pairs or bf16x2; LSE = m*ln2 +
//   log(l) by one lane of each quad; l == 0 gives O = 0 and LSE = -1e30.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int BLOCK_Q = 64;
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = 32 * NUM_WARPS;
constexpr int WARP_ROWS = BLOCK_Q / NUM_WARPS;  // one m16 MMA tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T, int D>
struct Tile {
  static constexpr int BLOCK_K = D >= 128 ? 32 : 64;
  static constexpr int CHUNK = 16 / static_cast<int>(sizeof(T));  // per cp.async
  static constexpr int STRIDE = D + CHUNK;  // shared-memory row, 16 bytes of pad
  static constexpr int KV_ELEMS = BLOCK_K * STRIDE;  // one K or V tile
  static constexpr int STAGE_ELEMS = 2 * KV_ELEMS;   // K then V
  static constexpr int Q_ELEMS = BLOCK_Q * STRIDE;
  static constexpr int SMEM_BYTES =
      (2 * STAGE_ELEMS + Q_ELEMS) * static_cast<int>(sizeof(T));
};

// ROWS x D elements from global rows at src (row stride `stride` elements,
// row 0 valid) to shared rows at dst (stride C::STRIDE); rows at or past
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

// minBlocksPerSM 1: without it ptxas holds f32 D=64 to 170 registers and
// spills at f32 D=16 and D=32 and at bf16 D=32
template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS, 1)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ lens,
               T* __restrict__ o, float* __restrict__ lse, int Lq, int Lk,
               int H, float scale_log2, int causal) {
  using C = Tile<T, D>;
  constexpr int BLOCK_K = C::BLOCK_K;
  constexpr int STRIDE = C::STRIDE;
  constexpr int KS = D / 8;        // k-steps of S = Q K^T
  constexpr int NT = BLOCK_K / 8;  // n-tiles of S = k-steps of O += P V
  constexpr int DT = D / 8;        // n-tiles of O
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  constexpr int PV_CHAIN = 4;     // k-steps of P V per f32 partial
  static_assert(NT % PV_CHAIN == 0, "uneven P V chain");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* const stage0 = smem;
  T* const stage1 = smem + C::STAGE_ELEMS;
  T* const qs = smem + 2 * C::STAGE_ELEMS;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // MMA group: rows g and g+8
  const int t = lane & 3;   // thread in group
  const int r0 = q0 + warp * WARP_ROWS;  // the warp's first query row
  const long long stride = static_cast<long long>(H) * D;

  // columns past kv_len are masked; a causal tile never looks past its
  // last row, so the K/V loop stops at kv_end
  const int kv_len = lens ? min(max(lens[b], 0), Lk) : Lk;
  const int kv_end = causal ? min(kv_len, q0 + BLOCK_Q) : kv_len;

  const long long head = static_cast<long long>(h) * D;
  const T* const kbase = k + static_cast<long long>(b) * Lk * stride + head;
  const T* const vbase = v + static_cast<long long>(b) * Lk * stride + head;
  // Q and the first K/V tile; the loop's first wait and barrier see them in
  if (kv_end > 0) {
    load_rows<T, D, BLOCK_Q>(qs, q + (static_cast<long long>(b) * Lq + q0) * stride + head,
                             stride, Lq - q0);
    load_rows<T, D, BLOCK_K>(stage0, kbase, stride, kv_end);
    load_rows<T, D, BLOCK_K>(stage0 + C::KV_ELEMS, vbase, stride, kv_end);
    cp_async_commit();
  }

  const T* const qwarp = qs + warp * WARP_ROWS * STRIDE;

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of rows g, g+8 (log2 units)
  float l[2] = {0.f, 0.f};          // this lane's part of the running sums

  for (int n = 0, k0 = 0; k0 < kv_end; ++n, k0 += BLOCK_K) {
    cp_async_wait<0>();
    // tile n is visible to every warp, and every warp is done with tile n-1,
    // whose buffer the next load reuses
    __syncthreads();
    if (k0 + BLOCK_K < kv_end) {
      T* const next = (n & 1) ? stage0 : stage1;
      const long long off = static_cast<long long>(k0 + BLOCK_K) * stride;
      load_rows<T, D, BLOCK_K>(next, kbase + off, stride, kv_end - k0 - BLOCK_K);
      load_rows<T, D, BLOCK_K>(next + C::KV_ELEMS, vbase + off, stride,
                               kv_end - k0 - BLOCK_K);
    }
    cp_async_commit();
    const T* const ks = (n & 1) ? stage1 : stage0;
    const T* const vs = ks + C::KV_ELEMS;

    // S = Q K^T: B = K^T, b0 = K[n0+g][k0+t], b1 = K[n0+g][k0+t+4]
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA a = load_a<T, STRIDE, EXACT>(qwarp + 8 * kk, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* const kp = ks + (8 * j + g) * STRIDE + 8 * kk + t;
        uint32_t b0, b0s, b1, b1s;
        split<EXACT>(widen(kp[0]), b0, b0s);
        split<EXACT>(widen(kp[4]), b1, b1s);
        mma3<EXACT, EXACT>(s[j], a, b0, b0s, b1, b1s);
      }
    }

    // online softmax on the C fragments: s[j][e] is row g + 8*(e>>1),
    // column k0 + 8j + 2t + (e&1)
    const bool edge = k0 + BLOCK_K > kv_len || (causal && k0 + BLOCK_K - 1 > r0);
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          if (col >= kv_len || (causal && col > row)) x = -INFINITY;
        }
        s[j][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m[r], tile_max[r]);  // finite: never below NEG_INF
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);  // masked: exp2(-inf) = 0
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V over the relabelled k index: the C registers of S's n-tile
    // kk are the A registers of k-step kk, and B reads V rows 2t and 2t+1.
    // Each PV_CHAIN k-steps go into a fresh partial, added to O in f32
    // with round-to-nearest (the MMAs' own sums round toward zero).
#pragma unroll
    for (int k2 = 0; k2 < NT; k2 += PV_CHAIN) {
      FragA p[PV_CHAIN];
#pragma unroll
      for (int c = 0; c < PV_CHAIN; ++c) {
        split<false>(s[k2 + c][0], p[c].big[0], p[c].small[0]);
        split<false>(s[k2 + c][2], p[c].big[1], p[c].small[1]);
        split<false>(s[k2 + c][1], p[c].big[2], p[c].small[2]);
        split<false>(s[k2 + c][3], p[c].big[3], p[c].small[3]);
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < PV_CHAIN; ++c) {
          const T* const vp = vs + (8 * (k2 + c) + 2 * t) * STRIDE + 8 * j + g;
          uint32_t b0, b0s, b1, b1s;
          split<EXACT>(widen(vp[0]), b0, b0s);
          split<EXACT>(widen(vp[STRIDE]), b1, b1s);
          mma3<false, EXACT>(part, p[c], b0, b0s, b1, b1s);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
      }
    }
  }

  const long long row_base = static_cast<long long>(b) * Lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + g + 8 * r;
    if (row >= Lq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* const orow = o + (row_base + row) * stride + head + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      store2(orow + 8 * j, acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    if (t == 0)
      lse[(row_base + row) * H + h] = l[r] > 0.f ? m[r] * LN2 + logf(l[r]) : NEG_INF;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lens,
           void* o, float* lse, int B, int Lq, int Lk, int H, float scale,
           int causal, cudaStream_t stream) {
  constexpr int smem = Tile<T, D>::SMEM_BYTES;
  if (smem > 48 * 1024) {
    // above 48 KB a CTA's dynamic shared memory has to be asked for, once
    // for each device (one bit each) and instantiation
    static std::atomic<uint64_t> asked{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (!(asked.load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(
          fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      asked.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  const dim3 grid((Lq + BLOCK_Q - 1) / BLOCK_Q, H, B);
  fwd_kernel<T, D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(o), lse, Lq, Lk, H,
      scale * LOG2E, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lens,
             void* o, float* lse, int B, int Lq, int Lk, int H, int D,
             float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lens, o, lse, B, Lq, Lk, H, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, lens, o, lse, B, Lq, Lk, H, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, lens, o, lse, B, Lq, Lk, H, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, lens, o, lse, B, Lq, Lk, H, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors, 16-byte aligned; `lens` may be null.  dtype:
// 0 = float32, 1 = bfloat16.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* lens, void* o, void* lse, int B,
                                   int Lq, int Lk, int H, int D, float scale,
                                   int causal, int dtype, void* stream) {
  const int* lens_i = static_cast<const int*>(lens);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, lens_i, o, lse_f, B, Lq, Lk, H, D, scale, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, lens_i, o, lse_f, B, Lq, Lk, H, D, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
