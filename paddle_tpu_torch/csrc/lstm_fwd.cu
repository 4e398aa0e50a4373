// LSTM recurrence, forward: the Hopper (sm_90a) counterpart of
// paddle_tpu/ops/pallas/lstm.py:_fwd_kernel (pallas_call at lstm.py:184).
//
// What it computes, for t = 0 .. T-1 and every batch row b (time-major):
//
//   gates = x[t, b] + h[b] . W + bias         (f32; W is [D, 4D])
//   cand, i, f, o = tanh(g_c), sig(g_i), sig(g_f), sig(g_o)   (gate order
//                                              candidate, input, forget, output)
//   c_new = f * c + i * cand,  h_new = o * tanh(c_new)
//   h = m * h_new + (1 - m) * h   (rounded to x's dtype),  c likewise in f32
//   hs[t, b] = h, cs[t, b] = c, and optionally acts[t, b] = [cand, i, f, o]
//
// with m = mask[t, b] in {0, 1}.  x, W, h0, hs and acts are float32 or
// bfloat16; bias, c0, mask and cs are float32; products accumulate in f32.
//
// Bound on the card at B=128, T=64, D=128, f32: 2 * B * T * D * 4D = 1.07
// GFLOP of products and 25 MB of inputs and outputs (7.6 us at 3.35 TB/s).
// But the T steps are dependent: each is a product over all of W that the
// next step waits for, so the real floor is the latency of a step.  The TPU
// kernel walks a (batch_blocks, T) grid in order with h and c in VMEM; here
// what a step costs is where W lives and how fast the new h reaches every
// CTA that needs it.
//
// Design (the walk's of lstm_bwd.cu, turned around: h . W instead of
// dgates . W^T).
// - A cluster of N CTAs owns kRows = 4 batch rows for all T steps (rows never
//   interact).  CTA rank c owns the U = D / N hidden units c*U .. c*U + U - 1
//   and keeps the four gate columns of those units, for all D rows of W, in
//   its shared memory for the whole call, gate-interleaved ([k][unit][gate]:
//   one 16-byte load gives a unit's four gates at row k in f32): 64 KB a CTA
//   at f32 D=128, N=4.  N is the smallest cluster (1, 2, 4 or 8) whose CTAs
//   hold all of W, raised while the doubled grid still runs in one wave
//   (every cluster placed at once, no more CTAs than SMs): the walk's rule,
//   cluster_sync.cuh choose_cluster.  At B=128, f32 D=128, N = 4, 128 CTAs
//   of 4 warps.  (The H100 places 30 clusters of 4 one CTA an SM; the other
//   clusters' CTAs share SMs with them, and those clusters' steps take
//   about 1.4x as long: they set the call's time.  N = 2, one CTA of 8 warps
//   an SM, takes as long.)  Where no cluster the plan takes holds all of W
//   (f32 D >= 352 and D = 288, bf16 D = 352, 416, 480, 512), the largest it
//   takes is used, and each CTA keeps the first rows it can; the rest
//   stream from L2 every step.  A cluster the card cannot place is an
//   error, never a smaller cluster.  W is copied
//   in at the start with 16-byte loads of the four gates of a few units and
//   16-byte interleaved stores (about 3 us at the slice's shape).
// - The product.  Warp w takes the CTA's units 8w .. 8w + 7; lane g * 8 + u
//   takes unit u for k-group g: k = g, g + 4, g + 8, ..., sixteen f32 FMA
//   chains (4 rows x 4 gates) fed by one 16-byte load of h (k-major: the 4
//   rows at k) and one of W a k.  Two butterfly levels (lanes 16 and 8
//   apart) halve the sixteen sums twice, so that lane (g, u) ends with the
//   four gate sums of row g: every lane owns one (row, unit) pair and keeps
//   its c and h in registers.  Every sum is (p0 + p2) + (p1 + p3), p_g the
//   chain over k-group g, whatever N is: the results do not depend on the
//   cluster size.  The loop is unrolled 8 times; measured no faster: 4
//   times, the next rounds' loads issued before the current rounds' FMAs,
//   and two units a lane over 8 k-groups (half the loads of h).  The
//   product stays on the f32 FMA pipe: a 4-row product fills at most a
//   quarter of an m16 MMA tile, and a 64-step recurrence magnifies rounding
//   (the walk's reason, lstm_bwd.cu).
// - The step.  Wait on this CTA's mbarrier until all of h_{t-1} is in
//   ([D][4] f32, 16 D bytes); the product; the gate math, with x_t and the
//   mask from the warp's shared-memory stage, filled by cp.async during the
//   step before; the unit's four rows gathered by shuffles and sent as one
//   16-byte st.async to every CTA of the cluster (the lane of row r sends to
//   ranks r, r + 4), each completing 16 bytes of the receiver's mbarrier
//   transaction count; then the stores of hs, cs and acts, and the copies of
//   step t+1's x and mask into the warp's other stage.  (Read from global
//   memory in the gate math instead, as the old kernel did, x doubles the
//   gate math's time.)  sigmoid and tanh are built on __expf and
//   __fdividef: half the gate math's time of expf, a full division and
//   tanhf, with the same error against the plain version.
// - h is double-buffered (a mbarrier each) by the parity of t, with no
//   cluster barrier and no block barrier in the loop.  No CTA can write h_t
//   into a buffer that a partner still reads h_{t-2} from: the writer first
//   needs all of h_{t-1}, and each warp of the partner sends its part of
//   h_{t-1} only after its own product over h_{t-2}.  A warp reads only its
//   own stage, so the stage needs no block barrier either.
// - Stores in flight slow shared-memory reads (the walk found it): hs, cs and
//   acts are stored after the sends, so they drain while the CTA waits for
//   the next h (stored after the next step's product instead: no faster).
//   profile_lstm_fwd.py prices each of these choices.
//
// Ragged edges: any B >= 1 and T >= 1; rows past B are masked in the kernel
// (their copies zero-filled, their stores skipped), never padded.  D must
// be a multiple of 32 in [32, 512]; a CTA holds a multiple of 8 units and at
// most 128 (16 warps), so the 16-byte copies of a warp's x columns fit in
// bf16 too.  Pointers 16-byte aligned.
//
// Plain C interface, bound with ctypes.  Launches on the caller's stream and
// returns cudaGetLastError().  The copy, cluster-address, st.async and
// mbarrier helpers are csrc/cluster_sync.cuh's, shared with lstm_bwd.cu.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "cluster_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 4;              // batch rows one cluster owns
constexpr int kGroups = 4;            // k-groups of a warp (lanes g * 8 + u)
constexpr int kWarpUnits = 32 / kGroups;  // units a warp takes
constexpr int kMaxThreads = 512;
constexpr int kMaxUnits = kMaxThreads / 32 * kWarpUnits;  // a CTA's units
static_assert(kRows == kGroups, "the butterfly leaves row g on k-group g");

// 32-bit word i of a 16-byte piece (i a constant once unrolled)
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  // four consecutive elements from shared memory
  static __device__ __forceinline__ float4 lds4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  // four units' gates 0-3 (one 16-byte piece a gate) -> [unit][gate] at dst
  static __device__ __forceinline__ void interleave(const uint4 (&g)[4],
                                                    float* dst) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<uint4*>(dst + 4 * u) = make_uint4(
          word(g[0], u), word(g[1], u), word(g[2], u), word(g[3], u));
  }
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
  static __device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  // eight units' gates 0-3 (one 16-byte piece a gate) -> [unit][gate] at
  // dst; word m of a piece holds units 2m (low half) and 2m + 1
  static __device__ __forceinline__ void interleave(const uint4 (&g)[4],
                                                    __nv_bfloat16* dst) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t w0 = word(g[0], m), w1 = word(g[1], m);
      const uint32_t w2 = word(g[2], m), w3 = word(g[3], m);
      *reinterpret_cast<uint4*>(dst + 8 * m) =
          make_uint4(__byte_perm(w0, w1, 0x5410), __byte_perm(w2, w3, 0x5410),
                     __byte_perm(w0, w1, 0x7632), __byte_perm(w2, w3, 0x7632));
    }
  }
};

// sigmoid and tanh from ex2.approx (__expf) and an approximate division
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__device__ __forceinline__ float tanh_f(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

// bytes of one step's stage of a warp: x [4 gates][kRows][8 units] in T,
// then the mask [kRows] in f32 (a multiple of 16 bytes)
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return 4 * kRows * kWarpUnits * (int)sizeof(T) + 4 * kRows;
}

// acc[r * 4 + q] += h[r] * w[q]: rows r, gates q
__device__ __forceinline__ void fma16(float (&acc)[16], float4 h, float4 w) {
  const float hr[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc[r * 4 + 0] = fmaf(hr[r], w.x, acc[r * 4 + 0]);
    acc[r * 4 + 1] = fmaf(hr[r], w.y, acc[r * 4 + 1]);
    acc[r * 4 + 2] = fmaf(hr[r], w.z, acc[r * 4 + 2]);
    acc[r * 4 + 3] = fmaf(hr[r], w.w, acc[r * 4 + 3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_fwd_kernel(const T* __restrict__ xs, const T* __restrict__ w,
                    const float* __restrict__ bias, const T* __restrict__ h0,
                    const float* __restrict__ c0,
                    const float* __restrict__ mask, T* __restrict__ hs,
                    float* __restrict__ cs, T* __restrict__ acts, int steps,
                    int batch, int d, int n_ctas, int resident, int ld) {
  constexpr int SB = stage_bytes<T>();
  constexpr int CHUNK = 16 / (int)sizeof(T);  // elements a 16-byte copy
  constexpr int X_CHUNKS = 4 * kRows * kWarpUnits / CHUNK;  // a warp's step
  extern __shared__ __align__(16) unsigned char smem[];
  const int d4 = 4 * d;
  const int units = d / n_ctas;
  const int warps = units / kWarpUnits;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);  // one an h buffer
  float4* const h_s = reinterpret_cast<float4*>(smem + 16);  // [2][d]: rows 0-3
  unsigned char* const stages = smem + 16 + 2 * 16 * d;      // [warps][2][SB]
  T* const w_s = reinterpret_cast<T*>(stages + warps * 2 * SB);  // [resident][ld]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = blockIdx.x % n_ctas;  // 1-D grid and cluster
  const int b0 = blockIdx.x / n_ctas * kRows;
  const int g = lane >> 3;  // k-group in the product, row after the butterfly
  const int u = lane & 7;
  const int ul = warp * kWarpUnits + u;  // unit of the CTA
  const int j = rank * units + ul;       // hidden unit
  const int r = g;
  const int b = b0 + r;
  const bool live = b < batch;

  {  // this CTA's gate columns of W's resident rows, gate-interleaved: a
     // thread reads the four gates' 16-byte pieces of CHUNK units at row k
     // and stores them interleaved in 16-byte pieces, kBatch such sets (16
     // loads) in flight at a time
    constexpr int kBatch = 4;
    const int per_row = units / CHUNK;
    const int n = resident * per_row;
    for (int i0 = tid; i0 < n; i0 += kBatch * blockDim.x) {
      uint4 v[kBatch][4];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * blockDim.x;
        const int k = i / per_row, u0 = (i - k * per_row) * CHUNK;
        const T* const src = w + (size_t)k * d4 + rank * units + u0;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          if (i < n)
            v[q][gate] = __ldg(reinterpret_cast<const uint4*>(src + gate * d));
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * blockDim.x;
        const int k = i / per_row, u0 = (i - k * per_row) * CHUNK;
        if (i < n) Cvt<T>::interleave(v[q], w_s + (size_t)k * ld + u0 * 4);
      }
    }
  }
  // h0 of the cluster's rows into buffer 0, every unit (rows past B: 0)
  for (int k = tid; k < d; k += blockDim.x) {
    float v[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      v[rr] = b0 + rr < batch ? Cvt<T>::to_f(h0[(size_t)(b0 + rr) * d + k])
                              : 0.f;
    h_s[k] = make_float4(v[0], v[1], v[2], v[3]);
  }
  const uint32_t bar_base = smem_addr(bars);
  const uint32_t h_base = smem_addr(h_s);
  if (tid == 0) {
    mbar_init(bar_base, 1);
    mbar_init(bar_base + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The warp's copies of step t's x columns ([gate][row][8 units]) and mask
  // into its stage s: lane i < X_CHUNKS copies 16 bytes, lanes 0-3 also the
  // mask of row `lane`; rows past B zero-filled.  Offsets worked out once.
  unsigned char* const stage = stages + warp * 2 * SB;
  const uint32_t stage_base = smem_addr(stage);
  const int xr = (lane / (kWarpUnits / CHUNK)) % kRows;
  const int x_gate = lane / (kWarpUnits / CHUNK) / kRows;
  const int x_part = lane % (kWarpUnits / CHUNK);
  const bool x_live = lane < X_CHUNKS && b0 + xr < batch;
  const size_t x_off = (size_t)(b0 + xr) * d4 + x_gate * d + rank * units +
                       warp * kWarpUnits + x_part * CHUNK;
  const uint32_t x_dst = lane * 16;
  const bool m_live = lane < kRows && b0 + lane < batch;
  const uint32_t m_dst = 4 * kRows * kWarpUnits * sizeof(T) + 4 * lane;
  auto prefetch = [&](int t, int s) {
    const size_t tb = (size_t)t * batch;
    const uint32_t to = stage_base + s * SB;
    if (lane < X_CHUNKS)
      cp_async16(to + x_dst, x_live ? xs + tb * d4 + x_off : xs, x_live);
    if (lane < kRows)
      cp_async4(to + m_dst, m_live ? mask + tb + b0 + lane : mask, m_live);
    cp_async_commit();
  };
  prefetch(0, 0);

  const float bc = bias[j], bi = bias[d + j];
  const float bf = bias[2 * d + j], bo = bias[3 * d + j];
  float h_reg = live ? Cvt<T>::to_f(h0[(size_t)b * d + j]) : 0.f;
  float c_reg = live ? c0[(size_t)b * d + j] : 0.f;
  const T* const w_unit = w_s + ul * 4;
  const uint32_t slot = h_base + 16 * j;  // unit j's place in buffer 0
  // every CTA of the cluster has started, initialised its barriers and
  // filled its W and h0 before any CTA sends into it
  cg::this_cluster().sync();

  for (int t = 0; t < steps; ++t) {
    const int s = t & 1;
    const bool send = t + 1 < steps;
    // h_t's buffer: armed once a phase, by one thread, before its own sends
    if (tid == 0 && send) mbar_expect(bar_base + 8 * (s ^ 1), 16 * d);
    // all of h_{t-1}, from every CTA of the cluster
    if (t > 0) mbar_wait(bar_base + 8 * s, ((t - 1) >> 1) & 1);

    // the product h_{t-1} . W for unit ul over k-group g: rows x gates
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    const float4* const hb = h_s + s * d;
    int k = g;
#pragma unroll 8
    for (; k < resident; k += kGroups)
      fma16(acc, hb[k], Cvt<T>::lds4(w_unit + (size_t)k * ld));
    for (; k < d; k += kGroups) {  // rows streamed from L2
      const T* const wg = w + (size_t)k * d4 + j;
      fma16(acc, hb[k],
            make_float4(Cvt<T>::to_f(__ldg(wg)), Cvt<T>::to_f(__ldg(wg + d)),
                        Cvt<T>::to_f(__ldg(wg + 2 * d)),
                        Cvt<T>::to_f(__ldg(wg + 3 * d))));
    }
    // k-groups g and g ^ 2 (lanes 16 apart), then g and g ^ 1 (8 apart): each
    // level keeps the half of the rows that the lane's bit selects
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool up = lane & 16;
      const float out = up ? acc[i] : acc[i + 8];
      const float keep = up ? acc[i + 8] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, out, 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool up = lane & 8;
      const float out = up ? acc[i] : acc[i + 4];
      const float keep = up ? acc[i + 4] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, out, 8);
    }

    // the gate math of (row r, unit j): x_t and the mask from stage s
    cp_async_wait_all();
    __syncwarp();
    const T* const xst = reinterpret_cast<const T*>(stage + s * SB);
    const float* const mst =
        reinterpret_cast<const float*>(xst + 4 * kRows * kWarpUnits);
    constexpr int GATE = kRows * kWarpUnits;  // a gate's x in the stage
    const int xi = r * kWarpUnits + u;
    const float gc = (Cvt<T>::to_f(xst[xi]) + acc[0]) + bc;
    const float gi = (Cvt<T>::to_f(xst[GATE + xi]) + acc[1]) + bi;
    const float gf = (Cvt<T>::to_f(xst[2 * GATE + xi]) + acc[2]) + bf;
    const float go = (Cvt<T>::to_f(xst[3 * GATE + xi]) + acc[3]) + bo;
    const float m = mst[r];
    const float ig = sigmoid_f(gi), fg = sigmoid_f(gf), og = sigmoid_f(go);
    const float cand = tanh_f(gc);
    const float c_new = fg * c_reg + ig * cand;
    const float h_new = og * tanh_f(c_new);
    const float h_out = Cvt<T>::round(m * h_new + (1.f - m) * h_reg);
    const float c_out = m * c_new + (1.f - m) * c_reg;
    h_reg = h_out;
    c_reg = c_out;

    if (send) {  // unit j's four rows, to every CTA of the cluster
      const float4 col = make_float4(
          __shfl_sync(0xffffffffu, h_out, u),
          __shfl_sync(0xffffffffu, h_out, u + 8),
          __shfl_sync(0xffffffffu, h_out, u + 16),
          __shfl_sync(0xffffffffu, h_out, u + 24));
      const uint32_t to = slot + 16 * d * (s ^ 1);
      const uint32_t bar = bar_base + 8 * (s ^ 1);
      for (int q = r; q < n_ctas; q += kRows)
        st_async16(map_rank(to, q), col, map_rank(bar, q));
    }
    if (live) {
      const size_t row = (size_t)t * batch + b;
      hs[row * d + j] = Cvt<T>::from_f(h_out);
      cs[row * d + j] = c_out;
      if (acts != nullptr) {
        T* const a = acts + row * d4 + j;
        a[0] = Cvt<T>::from_f(cand);
        a[d] = Cvt<T>::from_f(ig);
        a[2 * d] = Cvt<T>::from_f(fg);
        a[3 * d] = Cvt<T>::from_f(og);
      }
    }
    // step t+1's inputs into the other stage, which this warp last read at
    // step t-1 (the butterfly's shuffles since have synchronised the warp)
    if (send) prefetch(t + 1, s ^ 1);
  }
  // no CTA leaves while a partner's st.async may still be in flight to it
  cg::this_cluster().sync();
}

// The launch geometry for a cluster of n CTAs: units a CTA owns, warps,
// W's rows kept in shared memory, their row stride (elements) and the shared
// memory it takes.  bf16 rows are padded so that a half-warp's 8-byte loads
// (k-groups g and g + 1) fall on opposite halves of the banks.
struct FwdPlan {
  int units, threads, resident, ld;
  size_t smem;
};

template <typename T>
bool plan_fwd(int d, int n, FwdPlan* plan) {
  if (n < 1 || n > kMaxCluster || d % n) return false;
  const int units = d / n;
  if (units % kWarpUnits != 0 || units > kMaxUnits) return false;
  const int ld =
      4 * units + (sizeof(T) == 2 && 8 * units % 128 == 0 ? 32 : 0);
  const int warps = units / kWarpUnits;
  const size_t fixed =
      16 + 2 * 16 * (size_t)d + 2 * (size_t)warps * stage_bytes<T>();
  if (fixed >= (size_t)kMaxSmem) return false;
  const size_t fit = ((size_t)kMaxSmem - fixed) / ((size_t)ld * sizeof(T));
  plan->units = units;
  plan->threads = 32 * warps;
  // whole k-groups' rounds, so that a warp's lanes leave shared memory for
  // L2 at the same k
  plan->resident = fit >= (size_t)d ? d : (int)fit / kGroups * kGroups;
  plan->ld = ld;
  plan->smem = fixed + (size_t)plan->resident * ld * sizeof(T);
  return true;
}

// The plan's verdict on clusters of n CTAs (cluster_sync.cuh)
template <typename T>
int fit_fwd(int d, int n) {
  FwdPlan plan;
  if (!plan_fwd<T>(d, n, &plan)) return kRefused;
  return plan.resident < d ? kStreams : kHolds;
}

template <typename T>
using FwdLaunch = ClusterLaunch<decltype(&lstm_fwd_kernel<T>), FwdPlan>;

// The launch with clusters of n CTAs: its plan and configuration.
template <typename T>
cudaError_t fwd_launch(int batch, int d, int n, cudaStream_t stream,
                       FwdLaunch<T>* fl) {
  if (!plan_fwd<T>(d, n, &fl->plan)) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> asked{0};
  fl->kernel = lstm_fwd_kernel<T>;
  return fl->configure((batch + kRows - 1) / kRows, n, stream, &asked);
}

// The cluster size lstm_fwd launches with (cluster_sync.cuh's rule, as the
// walk's).  At f32 D = 288, 352, 416, 480 and bf16 D = 352, 416, 480 no
// cluster holds all of W and 8 CTAs would not hold a multiple of 8 units:
// 4 CTAs, some rows from L2.
template <typename T>
int auto_cluster(int batch, int d) {
  return choose_cluster(
      (batch + kRows - 1) / kRows, [d](int n) { return fit_fwd<T>(d, n); },
      [batch, d](int n) {
        FwdLaunch<T> fl;
        return fwd_launch<T>(batch, d, n, nullptr, &fl) == cudaSuccess
                   ? fl.placed()
                   : 0;
      });
}

template <typename T>
int launch(const void* xs, const void* w, const void* bias, const void* h0,
           const void* c0, const void* mask, void* hs, void* cs, void* acts,
           int steps, int batch, int d, int n, cudaStream_t stream) {
  FwdLaunch<T> fl;
  const cudaError_t err = fwd_launch<T>(batch, d, n, stream, &fl);
  if (err != cudaSuccess) return (int)err;
  return fl.launch(
      static_cast<const T*>(xs), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const T*>(h0),
      static_cast<const float*>(c0), static_cast<const float*>(mask),
      static_cast<T*>(hs), static_cast<float*>(cs), static_cast<T*>(acts),
      steps, batch, d, n, fl.plan.resident, fl.plan.ld);
}

bool bad_shape(int steps, int batch, int d) {
  return steps < 1 || batch < 1 || d < 32 || d > kMaxThreads || d % 32 != 0;
}

}  // namespace

extern "C" {

// The forward's cluster size for (batch, d, dtype) on the current device, as
// lstm_fwd launches it; negative on an error.  The choice for the last
// (device, batch, d, dtype) asked is kept.
int lstm_fwd_cluster(int batch, int d, int dtype) {
  if (bad_shape(1, batch, d) || (dtype != 0 && dtype != 1)) return -1;
  return cached_cluster(batch, d, dtype, [](int batch, int d, int dtype) {
    return dtype == 0 ? auto_cluster<float>(batch, d)
                      : auto_cluster<__nv_bfloat16>(batch, d);
  });
}

// What the forward's plan makes of clusters of `cluster` CTAs at width d:
// -1 it does not take them, 0 it does with some of W's rows streaming from
// L2, 1 it does with all of W held in the CTAs' shared memory.
int lstm_fwd_fit(int d, int dtype, int cluster) {
  if (bad_shape(1, 1, d) || (dtype != 0 && dtype != 1)) return kRefused;
  return dtype == 0 ? fit_fwd<float>(d, cluster)
                    : fit_fwd<__nv_bfloat16>(d, cluster);
}

// The forward with a cluster of `cluster` CTAs (1, 2, 4 or 8 that divides d
// into a multiple of 8 units, at most 128, a CTA; 0: lstm_fwd_cluster's
// choice).  dtype: 0 float32, 1 bfloat16 (of xs, w, h0, hs, acts).  acts
// may be null.  Returns a cudaError_t; 1 (invalid value) for shapes or
// cluster sizes the kernel does not take.
int lstm_fwd_with_cluster(const void* xs, const void* w, const void* bias,
                          const void* h0, const void* c0, const void* mask,
                          void* hs, void* cs, void* acts, int steps,
                          int batch, int d, int dtype, int cluster,
                          void* stream) {
  if (bad_shape(steps, batch, d) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (cluster == 0) cluster = lstm_fwd_cluster(batch, d, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xs, w, bias, h0, c0, mask, hs, cs, acts, steps,
                         batch, d, cluster, s);
  return launch<__nv_bfloat16>(xs, w, bias, h0, c0, mask, hs, cs, acts,
                               steps, batch, d, cluster, s);
}

// The forward with the library's cluster size.
int lstm_fwd(const void* xs, const void* w, const void* bias, const void* h0,
             const void* c0, const void* mask, void* hs, void* cs, void* acts,
             int steps, int batch, int d, int dtype, void* stream) {
  return lstm_fwd_with_cluster(xs, w, bias, h0, c0, mask, hs, cs, acts, steps,
                               batch, d, dtype, 0, stream);
}

}  // extern "C"
