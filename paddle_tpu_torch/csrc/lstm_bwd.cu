// LSTM recurrence, backward: the Hopper (sm_90a) counterpart of
// paddle_tpu/ops/pallas/lstm.py:_bwd_kernel (pallas_call at lstm.py:221).
//
// Two entry points:
//
// lstm_bwd (the reverse-time walk).  For t = T-1 .. 0 and every batch row b,
// from the forward's gate activations acts = [cand, i, f, o] and cell states:
//
//   c_prev = cs[t-1, b] (c0 at t = 0);  c_new = f * c_prev + i * cand
//   dh = dhs[t, b] + dh_carry,  dc = dcs[t, b] + dc_carry
//   dh_new = m * dh;  dc_new = m * dc + dh_new * o * (1 - tanh(c_new)^2)
//   dgates = [dc_new i (1 - cand^2), dc_new cand i (1 - i),
//             dc_new c_prev f (1 - f), dh_new tanh(c_new) o (1 - o)]
//   dx[t, b] = dgates (x's dtype; dg16 below is the same rounding)
//   dh_carry = (1 - m) * dh + dg16 . W^T,  dc_carry = (1 - m) * dc + dc_new f
//
// and at the end dh0 = dh_carry, dc0 = dc_carry.  Each cluster also writes
// the f32 sum of its rows' dgates over all steps (db_part, one row per
// cluster): the TPU kernel's db sums the f32 dgates, before they round to
// x's dtype.
//
// lstm_bwd_dw.  dW = sum over (t, b) of h_prev[t, b]^T . dg16[t, b], with
// h_prev = hs[t-1] (h0 at t = 0) read in place through a shifted row index
// and dg16 read back from dx: a [D, T*B] x [T*B, 4D] product with f32 sums.
// The TPU carries dW in VMEM scratch across its sequential grid; here blocks
// run in no order, so a split-K kernel writes one f32 partial per K slice and
// a second kernel sums the slices, and the clusters' db rows, in a fixed
// order.  No atomics: the result is the same from run to run.
//
// Bound on the card at B=128, T=64, D=128, f32: the walk's dg16 . W^T is
// 2 * B * T * D * 4D = 1.07 GFLOP and it moves about 46 MB (acts, dhs, dcs,
// cs in; dx out): 14 us at 3.35 TB/s.  dW is another 1.07 GFLOP, 6.5 us at
// the 3xTF32 rate.  The walk's T dependent steps make its real floor latency:
// each step is a product over all of W that the next step waits for.
//
// Design of the walk.
// - A cluster of N CTAs owns kRows = 4 batch rows for all T steps (rows never
//   interact).  CTA rank c owns the U = D / N hidden units c*U .. c*U + U - 1
//   and keeps W's rows for them in shared memory, all 4D columns: W is read
//   from shared memory, not from L2, at every step.  N is the smallest
//   cluster (1, 2, 4 or 8) whose CTAs hold all of W, raised while the
//   doubled grid still runs in one wave (every cluster placed at once, no
//   more CTAs than SMs): at B=128, f32 D=128 that is N = 4, 128 CTAs of 4
//   warps (N = 2 ran within 1% of it, N = 1 at 2.2x: W from L2).  Where
//   W does not fit even in 8 CTAs (f32 D=512, bf16 D=512), each CTA keeps
//   the first rows it can and the rest stream from L2 every step.  A
//   cluster the card cannot place is an error, never a smaller cluster.
// - Phase A: the owner of (row r, unit j) computes the four dgates from the
//   staged inputs and its carries (dh, dc in registers).  The unit's four
//   row lanes transpose their dg16 by shuffles, and each sends one float4
//   (a gate, rows 0-3) to every CTA of the cluster with st.async, which
//   counts the bytes on the receiving CTA's mbarrier.  A CTA waits on its
//   own mbarrier until all 64D bytes of the step's [4D, 4] dg16 are in: no
//   cluster barrier and no release fence.  dg is double-buffered (a barrier
//   each) by the parity of t; no CTA can write step t - 2 into a buffer a
//   partner still reads for step t, because it first needs every CTA's step
//   t - 1, which each sends only after the block barrier that ends its step
//   t.  (A cluster barrier each step, barrier.cluster.arrive.release /
//   wait.acquire, measured slower: its release waits for all of the
//   thread's stores.)
// - Phase B: warp w takes UW units (8 where they divide U, else 4 or 2, at
//   most 16 warps); its lanes walk n = lane, lane + 32, ... against all UW
//   units at once (each float4 of dg serves UW units, four rows each), and
//   one butterfly over the warp reduces the UW * 4 sums with UW * 4 - 1 + 5 -
//   log2(UW * 4) shuffles, leaving the sum of (unit, row) idx on lanes idx *
//   32 / (UW * 4) and up.  That lane owns the pair in phase A: dh_carry
//   never leaves its registers.  Each (row, unit) sum runs in the same order
//   for every N and UW, so the results do not depend on the cluster size.
//   Each W element read from shared memory serves 4 rows, so the LSU feeds
//   the product at no more than the FMA pipe's rate; at N = 4 a CTA has 4
//   warps and the product is latency-bound.  Measured no faster: 4 or 2
//   units a warp (more warps, more dg reads), two loop iterations in
//   flight, and the columns split over more warps (a cross-warp reduction
//   and more shuffles).  The product stays on the f32 FMA pipe: it feeds a
//   64-step recurrence that the training check against the CPU holds
//   tightly, and a 4-row product would fill at most a quarter of an m16
//   MMA tile.
// - Prefetch: after phase A every thread issues its (at most two) 16-byte
//   cp.async copies of step t-1's inputs of the CTA's rows and units (acts,
//   c_prev, dhs, dcs; 4-byte copies of the mask) into a second stage, with
//   addresses worked out once before the loop; they land during the wait
//   and phase B and are waited for before the block barrier that ends the
//   step.  Rows past B are zero-filled by the copies' src-size operand.
//   (8 copies of 4 bytes by each pair's owner lengthen phase A; working the
//   copies' addresses out anew each step, with integer divisions, costs
//   more than it saves.)
// - dx (dg in x's dtype) is stored by the owners after phase B: stored in
//   phase A, its stores in flight slowed phase B's shared-memory reads.
//
// Design of dW.  64 x 64 output tiles over 4 warps of 32 x 32, K in tiles of
// 32 rows through two 16-byte cp.async stages, rows padded (f32 by 8 words,
// bf16 by 16 elements) so the fragment reads fall on distinct banks.  The
// products are mma.sync.m16n8k8 in 3xTF32 (f32 split into TF32 big + small;
// bf16 is exact in TF32, one MMA).  The tensor cores round an MMA's sum toward
// zero, so every K tile (4 k-steps, 12 MMAs) goes into a fresh partial that
// is added to the f32 accumulator with round-to-nearest; a chain over a whole
// K slice (256 rows at the slice's shape) would pull dW toward zero.
// Split-K slices (the wrapper asks for four tiles a SM: 33 slices at the
// slice's shape), one f32 partial each, are summed in a fixed order.
//
// Ragged edges: any B >= 1, T >= 1; a row with m = 0 at a step gets dx = 0
// there and passes dh, dc through; rows past B are masked in the kernels.
// D must be a multiple of 32 in [32, 512]; bf16 needs D / N a multiple of 8
// (16-byte copies of a CTA's units).  Pointers 16-byte aligned.
//
// Plain C interface, bound with ctypes.  Launches on the caller's stream and
// returns cudaGetLastError().  The copy, cluster-address, st.async and
// mbarrier helpers are csrc/cluster_sync.cuh's, shared with lstm_fwd.cu; the
// conversion helpers repeat lstm_fwd.cu's, and the TF32 split and MMA
// helpers tf32_mma.cuh's: each source builds into its own library.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "cluster_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 4;  // batch rows one cluster owns (as lstm_fwd.cu)
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

// dW tiles: BM x BN outputs, BK deep, 4 warps of 32 x 32
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int kDwThreads = 128;
constexpr int kChain = BK / 8;  // k-steps of MMAs per fresh partial

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// f32 words of one step's staged inputs for a CTA of `units` units: acts
// [kRows][4][units] and dhs [kRows][units] in T, c_prev and dcs
// [kRows][units] and the mask [kRows] in f32, rounded up to 16 bytes
template <typename T>
__host__ __device__ constexpr int stage_floats(int units) {
  return (int)((5 * kRows * units * sizeof(T) + 4 * (2 * kRows * units + kRows) +
                15) / 16 * 4);
}

// acc[q][r] += sum over n = n0 + lane, n0 + lane + 32, ... < n0 + span of
// dg[n][r] * W_q[n], W_q the q-th of UW rows d4 apart: from ws (shared
// memory) for q < nres, else from wg (rows streamed from L2).  ALL: every
// row is in shared memory.
template <typename T, int UW, bool ALL>
__device__ __forceinline__ void walk_product(float (&acc)[UW][kRows],
                                             const T* ws, const T* wg,
                                             int nres, int d4,
                                             const float* dg, int n0,
                                             int span, int lane) {
  // loads in flight: UW 8 spilled at 128 registers when unrolled
  constexpr int kUnroll = UW == 8 ? 1 : 4;
#pragma unroll kUnroll
  for (int n = n0 + lane; n < n0 + span; n += 32) {
    const float4 gv = *reinterpret_cast<const float4*>(dg + n * kRows);
#pragma unroll
    for (int q = 0; q < UW; ++q) {
      const T* row = ALL || q < nres ? ws : wg;
      const float wv = Cvt<T>::to_f(row[q * d4 + n]);
      acc[q][0] = fmaf(gv.x, wv, acc[q][0]);
      acc[q][1] = fmaf(gv.y, wv, acc[q][1]);
      acc[q][2] = fmaf(gv.z, wv, acc[q][2]);
      acc[q][3] = fmaf(gv.w, wv, acc[q][3]);
    }
  }
}

// The warp's sum of each of CNT values, as a butterfly: v[i] of lane l +
// v[i] of lane l ^ off at off = 16, 8, 4, 2, 1.  The first log2(CNT) levels
// halve the values a lane holds (it keeps the half its bit of off selects),
// so the result for value idx lands on lanes idx * 32 / CNT and up.
// Recursive so that every index is a constant and v stays in registers.
template <int CNT, int OFF = 16>
__device__ __forceinline__ float warp_sums(float* v, int lane) {
  if constexpr (CNT > 1) {
    const bool upper = lane & OFF;
#pragma unroll
    for (int i = 0; i < CNT / 2; ++i) {
      const float send = upper ? v[i] : v[i + CNT / 2];
      const float keep = upper ? v[i + CNT / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    return warp_sums<CNT / 2, OFF / 2>(v, lane);
  } else {
#pragma unroll
    for (int off = OFF; off > 0; off >>= 1)
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    return v[0];
  }
}

__device__ __forceinline__ float pick4(const float (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// The walk.  Warp w of a CTA takes units w * UW .. + UW of the CTA's
// `units`; the lane that warp_sums leaves the sum of (row r, unit k) on owns
// that pair in phase A.
template <typename T, int UW>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_bwd_walk_kernel(const T* __restrict__ w,
                         const float* __restrict__ mask,
                         const T* __restrict__ acts,
                         const float* __restrict__ cs,
                         const float* __restrict__ c0,
                         const T* __restrict__ dhs,
                         const float* __restrict__ dcs, T* __restrict__ dx,
                         T* __restrict__ dh0, float* __restrict__ dc0,
                         float* __restrict__ db_part, int steps, int batch,
                         int d, int n_ctas, int resident) {
  constexpr int V = UW * kRows;  // sums one warp reduces
  constexpr int SPREAD = 32 / V;  // lanes that end with the same sum
  // the lanes that end with a sum (lane % SPREAD == 0)
  constexpr unsigned OWNERS = SPREAD == 1   ? 0xffffffffu
                              : SPREAD == 2 ? 0x55555555u
                                            : 0x11111111u;
  constexpr int CHUNK = 16 / (int)sizeof(T);  // elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int d4 = 4 * d;
  const int units = d / n_ctas;
  const int pairs = kRows * units;
  const int stage_words = stage_floats<T>(units);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);  // one a dg buffer
  float* const dg_s = reinterpret_cast<float*>(smem + 16);  // [2][4d][kRows]
  float* const stage = dg_s + 2 * d4 * kRows;  // [2][stage_words]
  T* const w_s = reinterpret_cast<T*>(stage + 2 * stage_words);  // [resident][4d]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = blockIdx.x % n_ctas;  // 1-D grid and cluster
  const int b0 = blockIdx.x / n_ctas * kRows;
  const int k_base = rank * units;
  const bool owner = lane % SPREAD == 0;
  const int idx = lane / SPREAD;
  const int r = idx % kRows;
  const int k = warp * UW + idx / kRows;  // local unit
  const int j = k_base + k;               // hidden unit
  const int b = b0 + r;

  {  // this CTA's resident rows of W, 16 bytes a thread at a time
    const uint4* src = reinterpret_cast<const uint4*>(w + (size_t)k_base * d4);
    uint4* dst = reinterpret_cast<uint4*>(w_s);
    const int n16 = resident * d4 * (int)sizeof(T) / 16;
    for (int i = tid; i < n16; i += blockDim.x) dst[i] = src[i];
  }
  const uint32_t bar_base = smem_addr(bars);
  const uint32_t dg_base = smem_addr(dg_s);
  if (tid == 0) {
    mbar_init(bar_base, 1);
    mbar_init(bar_base + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // step t's inputs of the CTA's rows and units into stage s, 16-byte
  // copies by every thread (rows past B zero-filled): acts [kRows][4][units],
  // dhs [kRows][units] in T; c_prev, dcs [kRows][units] and the mask
  // [kRows] in f32.  Copied during step t + 1, waited for before its block
  // barrier.  A thread's copies are the same at every step but for t: their
  // kind (1 acts, 2 dhs, 3 c_prev, 4 dcs, 5 mask; 0 none), element offset at
  // t = 0 and place in the stage are worked out once (at most 2 a thread:
  // plan_walk checks it).
  const int act_chunks = kRows * 4 * units / CHUNK;
  const int row_chunks = kRows * units / CHUNK;  // dhs
  const int f32_chunks = kRows * units / 4;      // c_prev, dcs
  int kind[2], off[2];
  uint32_t dst[2];
  bool live[2];
  const uint32_t stage_base = smem_addr(stage);
  const uint32_t h_at = 4 * pairs * sizeof(T);  // dhs in the stage, bytes
  const uint32_t c_at = h_at + pairs * sizeof(T);  // c_prev, dcs, mask
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    int i = tid + c * blockDim.x, rr = 0;
    kind[c] = 0;
    off[c] = 0;
    dst[c] = 0;
    if (i < act_chunks) {
      const int e = i * CHUNK, gate = e / units % 4, u = e % units;
      rr = e / (4 * units);
      kind[c] = 1;
      off[c] = (b0 + rr) * d4 + gate * d + k_base + u;
      dst[c] = e * sizeof(T);
    } else if ((i -= act_chunks) < row_chunks) {
      const int e = i * CHUNK, u = e % units;
      rr = e / units;
      kind[c] = 2;
      off[c] = (b0 + rr) * d + k_base + u;
      dst[c] = h_at + e * sizeof(T);
    } else if ((i -= row_chunks) < 2 * f32_chunks) {
      const int which = i / f32_chunks, e = (i % f32_chunks) * 4;
      rr = e / units;
      kind[c] = 3 + which;
      off[c] = (b0 + rr) * d + k_base + e % units;
      dst[c] = c_at + 4 * (which * pairs + e);
    } else if ((i -= 2 * f32_chunks) < kRows) {
      rr = i;
      kind[c] = 5;
      off[c] = b0 + rr;
      dst[c] = c_at + 4 * (2 * pairs + rr);
    }
    live[c] = b0 + rr < batch;
  }
  const uint32_t stage_bytes = 4 * stage_words;
  auto prefetch = [&](int t, int s) {
    const size_t tb = (size_t)t * batch;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t to = stage_base + s * stage_bytes + dst[c];
      switch (kind[c]) {
        case 1: cp_async16(to, acts + (live[c] ? tb * d4 + off[c] : 0), live[c]); break;
        case 2: cp_async16(to, dhs + (live[c] ? tb * d + off[c] : 0), live[c]); break;
        case 3:
          cp_async16(to,
                     !live[c] ? cs : t > 0 ? cs + (tb - batch) * d + off[c]
                                           : c0 + off[c],
                     live[c]);
          break;
        case 4: cp_async16(to, dcs + (live[c] ? tb * d + off[c] : 0), live[c]); break;
        case 5: cp_async4(to, mask + (live[c] ? tb + off[c] : 0), live[c]); break;
        default: break;
      }
    }
  };

  prefetch(steps - 1, (steps - 1) & 1);
  cp_async_commit();
  cp_async_wait_all();
  // every CTA of the cluster has started, initialised its barriers and
  // staged its first inputs before any CTA writes into it
  cg::this_cluster().sync();

  float keep = 0.f;  // (1 - m) * dh of the last step
  float prod = 0.f;  // dg16 . W^T of the last step, this lane's (row, unit)
  float dc = 0.f;
  float db_acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int step_bytes = d4 * kRows * (int)sizeof(float);

  for (int t = steps - 1; t >= 0; --t) {
    const int s = t & 1;
    const uint32_t bar = bar_base + 8 * s;
    if (tid == 0) mbar_expect(bar, step_bytes);
    float dg[4];  // this lane's dgates, stored to dx after phase B
    if (owner) {
      // phase A: the gate gradients of (b, j), from the staged inputs
      const float* const st = stage + s * stage_words;
      const T* const a_s = reinterpret_cast<const T*>(st) + r * 4 * units + k;
      const T* const h_s = reinterpret_cast<const T*>(st) + 4 * pairs;
      const float* const c_s =
          reinterpret_cast<const float*>(h_s + pairs) + r * units + k;
      const float cand = Cvt<T>::to_f(a_s[0]);
      const float ig = Cvt<T>::to_f(a_s[units]);
      const float fg = Cvt<T>::to_f(a_s[2 * units]);
      const float og = Cvt<T>::to_f(a_s[3 * units]);
      const float c_prev = c_s[0];
      const float c_new = fg * c_prev + ig * cand;
      const float tc = tanhf(c_new);
      const float m = reinterpret_cast<const float*>(h_s + pairs)[2 * pairs + r];
      const float dh_tot = Cvt<T>::to_f(h_s[r * units + k]) + (keep + prod);
      const float dc_tot = c_s[pairs] + dc;
      const float dh_new = m * dh_tot;
      const float d_o = dh_new * tc;
      const float dc_new = m * dc_tot + dh_new * og * (1.f - tc * tc);
      dg[0] = (dc_new * ig) * (1.f - cand * cand);
      dg[1] = (dc_new * cand) * ig * (1.f - ig);
      dg[2] = (dc_new * c_prev) * fg * (1.f - fg);
      dg[3] = d_o * og * (1.f - og);
      float g16[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        db_acc[gate] += dg[gate];
        g16[gate] = Cvt<T>::round(dg[gate]);
      }
      // a 4 x 4 transpose over the unit's four lanes: the lane of row r
      // gathers gate r of rows 0-3 (round q: row (r - q) & 3) and sends
      // them as one 16-byte st.async to every CTA of the cluster, counted
      // by that CTA's barrier of this dg buffer
      const int base = lane - r * SPREAD;
      float4 col = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int from = (r - q) & 3;
        const float got = __shfl_sync(OWNERS, pick4(g16, (r + q) & 3),
                                      base + from * SPREAD);
        col.x = from == 0 ? got : col.x;
        col.y = from == 1 ? got : col.y;
        col.z = from == 2 ? got : col.z;
        col.w = from == 3 ? got : col.w;
      }
      const uint32_t slot =
          dg_base + 4 * (s * d4 * kRows + (r * d + j) * kRows);
      for (int q = 0; q < n_ctas; ++q)
        st_async16(map_rank(slot, q), col, map_rank(bar, q));
      keep = (1.f - m) * dh_tot;
      dc = (1.f - m) * dc_tot + dc_new * fg;
    }
    if (t > 0) prefetch(t - 1, s ^ 1);
    cp_async_commit();
    // all of step t's dg16, from every CTA of the cluster.  The buffer's
    // next use (step t - 2) cannot start filling before every CTA has sent
    // step t - 1, which it does only after this step's block barrier
    mbar_wait(bar, ((steps - 1 - t) >> 1) & 1);

    // phase B: dg16 . W^T for this warp's UW units, four rows
    const float* const dg_now = dg_s + s * d4 * kRows;
    float acc[UW][kRows];
#pragma unroll
    for (int q = 0; q < UW; ++q)
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) acc[q][rr] = 0.f;
    const int kw = warp * UW;
    const T* const ws = w_s + (size_t)kw * d4;
    if (kw + UW <= resident) {
      walk_product<T, UW, true>(acc, ws, ws, UW, d4, dg_now, 0, d4, lane);
    } else {  // some of these rows stream from L2
      walk_product<T, UW, false>(acc, ws, w + (size_t)(k_base + kw) * d4,
                                 resident - kw, d4, dg_now, 0, d4, lane);
    }
    prod = warp_sums<V>(&acc[0][0], lane);
    // dx here rather than in phase A: global stores in flight slowed the
    // shared-memory reads of phase B (profile_lstm_walk.py prices it)
    if (owner && b < batch) {
      T* const xo = dx + ((size_t)t * batch + b) * d4 + j;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        xo[gate * d] = Cvt<T>::from_f(dg[gate]);
    }

    cp_async_wait_all();  // step t - 1's inputs
    __syncthreads();
  }

  if (owner && b < batch) {
    dh0[(size_t)b * d + j] = Cvt<T>::from_f(keep + prod);
    dc0[(size_t)b * d + j] = dc;
  }
  // db: the four rows of each unit, in row order, by the row-0 lane
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {
    float sum = db_acc[gate];
#pragma unroll
    for (int rr = 1; rr < kRows; ++rr)
      sum += __shfl_sync(0xffffffffu, db_acc[gate], (lane + rr * SPREAD) & 31);
    if (owner && r == 0)
      db_part[(size_t)(blockIdx.x / n_ctas) * d4 + gate * d + j] = sum;
  }
  // no CTA leaves while a partner's st.async may still be in flight to it
  cg::this_cluster().sync();
}

// --- dW on the tensor cores (3xTF32 mma.sync) ------------------------------

constexpr uint32_t TF32_MASK = 0xffffe000u;  // sign, exponent, 10 mantissa bits

// x = big + small: big is x rounded to TF32 (to nearest, ties away from 0,
// as cvt.rna), small = x - big rounded the same way.  EXACT: x is already
// TF32 (a widened bf16), small is 0 and never read.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if (EXACT) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    big = (__float_as_uint(x) + 0x1000u) & TF32_MASK;
    small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & TF32_MASK;
  }
}

// D += A * B, m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
struct DwTile {
  static constexpr int CHUNK = 16 / static_cast<int>(sizeof(T));  // per cp.async
  // 16 bytes of pad or more: fragment reads at row t, column g fall on
  // distinct banks (f32: 8 words a row; bf16: 16 elements)
  static constexpr int SA = BM + (sizeof(T) == 4 ? 8 : 16);
  static constexpr int SB = BN + (sizeof(T) == 4 ? 8 : 16);
  static constexpr int A_ELEMS = BK * SA;
  static constexpr int STAGE_ELEMS = BK * (SA + SB);
  static constexpr int SMEM_BYTES = 2 * STAGE_ELEMS * static_cast<int>(sizeof(T));
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// part[s] = sum over K slice s of h_prev^T . dg16, one BM x BN tile a block
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    lstm_dw_partial_kernel(const T* __restrict__ hs, const T* __restrict__ h0,
                           const T* __restrict__ dx, float* __restrict__ part,
                           int k_total, int batch, int d, int k_per) {
  using C = DwTile<T>;
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) T smem[2 * C::STAGE_ELEMS];
  const int d4 = 4 * d;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, s = blockIdx.z;
  const int kbeg = s * k_per;
  const int kend = min(k_total, kbeg + k_per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // rows kb .. kb + BK of A (h_prev, [k][m]) and B (dx, [k][n]) into stage st
  auto load = [&](int kb, T* st) {
    constexpr int A_PER_ROW = BM / C::CHUNK, B_PER_ROW = BN / C::CHUNK;
    for (int i = threadIdx.x; i < BK * A_PER_ROW; i += kDwThreads) {
      const int kk = i / A_PER_ROW, c = (i % A_PER_ROW) * C::CHUNK;
      const int krow = kb + kk;
      const bool ok = krow < kend && m0 + c < d;
      // h_prev row (t, b) = h0[b] at t = 0, else hs[t-1, b]
      const T* src = !ok ? hs
                     : krow < batch ? h0 + (size_t)krow * d + m0 + c
                                    : hs + (size_t)(krow - batch) * d + m0 + c;
      cp_async16(st + kk * C::SA + c, src, ok);
    }
    T* const bs = st + C::A_ELEMS;
    for (int i = threadIdx.x; i < BK * B_PER_ROW; i += kDwThreads) {
      const int kk = i / B_PER_ROW, c = (i % B_PER_ROW) * C::CHUNK;
      const int krow = kb + kk;
      const bool ok = krow < kend && n0 + c < d4;
      cp_async16(bs + kk * C::SB + c,
                 ok ? dx + (size_t)krow * d4 + n0 + c : dx, ok);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.f;

  if (kbeg < kend) load(kbeg, smem);
  cp_async_commit();
  for (int kb = kbeg, n = 0; kb < kend; kb += BK, ++n) {
    cp_async_wait_all();
    // tile n is visible to every warp, and every warp is done with tile n-1,
    // whose buffer the next load reuses
    __syncthreads();
    if (kb + BK < kend) load(kb + BK, (n & 1) ? smem : smem + C::STAGE_ELEMS);
    cp_async_commit();
    const T* const as = (n & 1) ? smem + C::STAGE_ELEMS : smem;
    const T* const bs = as + C::A_ELEMS;

    // this K tile's kChain k-steps into a fresh partial (the MMAs' sums
    // round toward zero), added to acc with round-to-nearest
    float fresh[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) fresh[i][jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kChain; ++kk) {
      // A[m][k] = as[k][m]: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
      // a3 = A[g+8][t+4]
      uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* ap = as + (8 * kk + t) * C::SA + wm + 16 * i + g;
        split<EXACT>(widen(ap[0]), a_big[i][0], a_small[i][0]);
        split<EXACT>(widen(ap[8]), a_big[i][1], a_small[i][1]);
        split<EXACT>(widen(ap[4 * C::SA]), a_big[i][2], a_small[i][2]);
        split<EXACT>(widen(ap[4 * C::SA + 8]), a_big[i][3], a_small[i][3]);
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        // b0 = B[k=t][n=g], b1 = B[k=t+4][n=g]
        const T* bp = bs + (8 * kk + t) * C::SB + wn + 8 * jn + g;
        uint32_t b0, b0s, b1, b1s;
        split<EXACT>(widen(bp[0]), b0, b0s);
        split<EXACT>(widen(bp[4 * C::SB]), b1, b1s);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!EXACT) {
            mma(fresh[i][jn], a_small[i], b0, b1);
            mma(fresh[i][jn], a_big[i], b0s, b1s);
          }
          mma(fresh[i][jn], a_big[i], b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jn][e] += fresh[i][jn][e];
  }

  // c0, c1 = C[g][2t, 2t+1]; c2, c3 = C[g+8][2t, 2t+1]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= d) continue;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int n = n0 + wn + 8 * jn + 2 * t;
        if (n < d4)
          *reinterpret_cast<float2*>(part + ((size_t)s * d + m) * d4 + n) =
              make_float2(acc[i][jn][2 * h], acc[i][jn][2 * h + 1]);
      }
    }
}

// dw = sum of the K slices, db = sum of the walk clusters' rows, fixed order
__global__ void lstm_dw_reduce_kernel(const float* __restrict__ part,
                                      const float* __restrict__ db_part,
                                      float* __restrict__ dw,
                                      float* __restrict__ db, int d,
                                      int splits, int walk_clusters) {
  const size_t n_w = (size_t)d * 4 * d;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n_w) {
    float s = 0.f;
    for (int i = 0; i < splits; ++i) s += part[(size_t)i * n_w + idx];
    dw[idx] = s;
  } else if (idx < n_w + 4 * (size_t)d) {
    const size_t n = idx - n_w;
    float s = 0.f;
    for (int i = 0; i < walk_clusters; ++i) s += db_part[(size_t)i * 4 * d + n];
    db[n] = s;
  }
}

// --- the walk's launch geometry --------------------------------------------

// The walk's launch geometry for a cluster of n CTAs: the units a CTA owns,
// the units a warp takes (UW: 8 where it divides them, so each float4 of dg
// read from shared memory serves the most units; else 4 or 2; at most 16
// warps), W's rows kept in shared memory and the shared memory it takes.
// A CTA's rows of one gate are copied in 16-byte pieces, so bf16 needs a
// multiple of 8 units.
struct WalkPlan {
  int units, uw, threads, resident;
  size_t smem;
};

template <typename T>
bool plan_walk(int d, int n, WalkPlan* plan) {
  if (n < 1 || n > kMaxCluster || d % n) return false;
  const int units = d / n;
  const int uw = units % 8 == 0 ? 8 : units % 4 == 0 ? 4 : units % 2 == 0 ? 2 : 0;
  if (uw == 0 || units / uw > kMaxWarps ||
      units * sizeof(T) % 16 != 0)
    return false;
  const size_t fixed = 16 + sizeof(float) * (2 * 4 * (size_t)d * kRows +
                                             2 * (size_t)stage_floats<T>(units));
  if (fixed >= (size_t)kMaxSmem) return false;
  const size_t fit = ((size_t)kMaxSmem - fixed) / (4 * (size_t)d * sizeof(T));
  const int threads = 32 * (units / uw);
  const int chunks = (5 * kRows * units * (int)sizeof(T) + 4 * 2 * kRows * units) / 16 +
                     kRows;  // the walk's 16-byte copies of a step, + mask
  if (chunks > 2 * threads) return false;  // at most 2 copies a thread
  plan->units = units;
  plan->uw = uw;
  plan->threads = threads;
  plan->resident = fit < (size_t)units ? (int)fit : units;
  plan->smem = fixed + (size_t)plan->resident * 4 * d * sizeof(T);
  return true;
}

// The plan's verdict on clusters of n CTAs (cluster_sync.cuh)
template <typename T>
int fit_walk(int d, int n) {
  WalkPlan plan;
  if (!plan_walk<T>(d, n, &plan)) return kRefused;
  return plan.resident < plan.units ? kStreams : kHolds;
}

template <typename T>
using WalkKernel = void (*)(const T*, const float*, const T*, const float*,
                            const float*, const T*, const float*, T*, T*,
                            float*, float*, int, int, int, int, int);

template <typename T>
WalkKernel<T> walk_kernel(int uw) {
  switch (uw) {
    case 2: return lstm_bwd_walk_kernel<T, 2>;
    case 4: return lstm_bwd_walk_kernel<T, 4>;
    case 8: return lstm_bwd_walk_kernel<T, 8>;
    default: return nullptr;
  }
}

template <typename T>
using WalkLaunch = ClusterLaunch<WalkKernel<T>, WalkPlan>;

// The launch of the walk with clusters of n CTAs: its kernel, plan and
// configuration.
template <typename T>
cudaError_t walk_launch(int batch, int d, int n, cudaStream_t stream,
                        WalkLaunch<T>* wl) {
  if (!plan_walk<T>(d, n, &wl->plan)) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> asked[9];  // one for each instantiation
  wl->kernel = walk_kernel<T>(wl->plan.uw);
  return wl->configure((batch + kRows - 1) / kRows, n, stream,
                       &asked[wl->plan.uw]);
}

// The walk's cluster size (cluster_sync.cuh's rule).  At bf16 D = 352,
// 416 and 480 no cluster holds all of W and 8 CTAs would not copy whole
// 16-byte pieces of a gate's row: 4 CTAs, some rows from L2.
template <typename T>
int auto_cluster(int batch, int d) {
  return choose_cluster(
      (batch + kRows - 1) / kRows, [d](int n) { return fit_walk<T>(d, n); },
      [batch, d](int n) {
        WalkLaunch<T> wl;
        return walk_launch<T>(batch, d, n, nullptr, &wl) == cudaSuccess
                   ? wl.placed()
                   : 0;
      });
}

template <typename T>
int launch_walk(const void* w, const void* mask, const void* acts,
                const void* cs, const void* c0, const void* dhs,
                const void* dcs, void* dx, void* dh0, void* dc0,
                void* db_part, int steps, int batch, int d, int n,
                cudaStream_t stream) {
  WalkLaunch<T> wl;
  const cudaError_t err = walk_launch<T>(batch, d, n, stream, &wl);
  if (err != cudaSuccess) return (int)err;
  return wl.launch(
      static_cast<const T*>(w), static_cast<const float*>(mask),
      static_cast<const T*>(acts), static_cast<const float*>(cs),
      static_cast<const float*>(c0), static_cast<const T*>(dhs),
      static_cast<const float*>(dcs), static_cast<T*>(dx),
      static_cast<T*>(dh0), static_cast<float*>(dc0),
      static_cast<float*>(db_part), steps, batch, d, n, wl.plan.resident);
}

template <typename T>
int launch_dw(const void* hs, const void* h0, const void* dx,
              const void* db_part, void* part, void* dw, void* db, int steps,
              int batch, int d, int splits, cudaStream_t stream) {
  const int k_total = steps * batch;
  int k_per = (k_total + splits - 1) / splits;
  k_per = (k_per + BK - 1) / BK * BK;
  const dim3 grid((4 * d + BN - 1) / BN, (d + BM - 1) / BM, splits);
  lstm_dw_partial_kernel<T><<<grid, kDwThreads, 0, stream>>>(
      static_cast<const T*>(hs), static_cast<const T*>(h0),
      static_cast<const T*>(dx), static_cast<float*>(part), k_total, batch, d,
      k_per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)d * 4 * d + 4 * (size_t)d;
  const int walk_clusters = (batch + kRows - 1) / kRows;
  lstm_dw_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(db_part),
      static_cast<float*>(dw), static_cast<float*>(db), d, splits,
      walk_clusters);
  return (int)cudaGetLastError();
}

bool bad_shape(int steps, int batch, int d) {
  return steps < 1 || batch < 1 || d < 32 || d > kMaxThreads || d % 32 != 0;
}

}  // namespace

extern "C" {

// The walk's cluster size for (batch, d, dtype) on the current device, as
// lstm_bwd launches it; negative on an error.  The choice for the last
// (device, batch, d, dtype) asked is kept.
int lstm_bwd_cluster(int batch, int d, int dtype) {
  if (bad_shape(1, batch, d) || (dtype != 0 && dtype != 1)) return -1;
  return cached_cluster(batch, d, dtype, [](int batch, int d, int dtype) {
    return dtype == 0 ? auto_cluster<float>(batch, d)
                      : auto_cluster<__nv_bfloat16>(batch, d);
  });
}

// What the walk's plan makes of clusters of `cluster` CTAs at width d: -1
// it does not take them, 0 it does with some of W's rows streaming from
// L2, 1 it does with all of W held in the CTAs' shared memory.
int lstm_bwd_fit(int d, int dtype, int cluster) {
  if (bad_shape(1, 1, d) || (dtype != 0 && dtype != 1)) return kRefused;
  return dtype == 0 ? fit_walk<float>(d, cluster)
                    : fit_walk<__nv_bfloat16>(d, cluster);
}

// The reverse-time walk with a cluster of `cluster` CTAs (1, 2, 4 or 8 that
// divides d into at most 128 units a CTA; 0: lstm_bwd_cluster's choice).
int lstm_bwd_with_cluster(const void* w, const void* mask, const void* acts,
                          const void* cs, const void* c0, const void* dhs,
                          const void* dcs, void* dx, void* dh0, void* dc0,
                          void* db_part, int steps, int batch, int d,
                          int dtype, int cluster, void* stream) {
  if (bad_shape(steps, batch, d) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (cluster == 0) cluster = lstm_bwd_cluster(batch, d, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_walk<float>(w, mask, acts, cs, c0, dhs, dcs, dx, dh0, dc0,
                              db_part, steps, batch, d, cluster, s);
  return launch_walk<__nv_bfloat16>(w, mask, acts, cs, c0, dhs, dcs, dx, dh0,
                                    dc0, db_part, steps, batch, d, cluster, s);
}

// The reverse-time walk.  dtype: 0 float32, 1 bfloat16 (of w, acts, dhs, dx,
// dh0).  db_part is [ceil(batch / kRows), 4d] f32.
int lstm_bwd(const void* w, const void* mask, const void* acts,
             const void* cs, const void* c0, const void* dhs,
             const void* dcs, void* dx, void* dh0, void* dc0, void* db_part,
             int steps, int batch, int d, int dtype, void* stream) {
  return lstm_bwd_with_cluster(w, mask, acts, cs, c0, dhs, dcs, dx, dh0, dc0,
                               db_part, steps, batch, d, dtype, 0, stream);
}

// dW [d, 4d] f32 and db [4d] f32 from hs, h0, dx (the walk's output) and the
// walk's db_part; part is [splits, d, 4d] f32 scratch.
int lstm_bwd_dw(const void* hs, const void* h0, const void* dx,
                const void* db_part, void* part, void* dw, void* db,
                int steps, int batch, int d, int splits, int dtype,
                void* stream) {
  if (bad_shape(steps, batch, d) || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dw<float>(hs, h0, dx, db_part, part, dw, db, steps, batch,
                            d, splits, s);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(hs, h0, dx, db_part, part, dw, db, steps,
                                    batch, d, splits, s);
  return (int)cudaErrorInvalidValue;
}

int lstm_bwd_rows_per_block(void) { return kRows; }

// K rows of one dW tile step: a K slice is a multiple of it
int lstm_bwd_dw_tile(void) { return BK; }

}  // extern "C"
