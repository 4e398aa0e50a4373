// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_fwd_impl` through pallas_call).  Computes,
// per batch row b, head h and query row i:
//
//   O[b,i,h,:]  = softmax_j(scale * q_i . k_j)[masked] . V
//   LSE[b,i,h]  = m + log(l)            (f32)
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
// in its two products and moves q, k, v and O once: 4 * 8.4 MB = 34 MB in
// f32.  That is 32 us at the H100's 67 TFLOP/s f32 rate outside the tensor
// cores against 10 us at 3.35 TB/s, so in f32 without tensor cores it is
// compute-bound (about 64 FLOP per byte).
//
// Design.  One CTA of 256 threads per (64-row q tile, head, batch row).
// Four neighbouring lanes share one query row; each holds a quarter of the
// row's q (pre-multiplied by scale*log2(e)) and of its output accumulator in
// registers, in 16-byte chunks interleaved so that the four lanes read one
// contiguous 64-byte run of a K/V row from shared memory while the eight
// rows of a warp read the same address (a broadcast).  K/V tiles of BLOCK_K
// rows stream through shared memory, converted to f32 on the way in.  Per
// tile each lane forms partial dot products, two xor-shuffles complete them,
// and the online softmax keeps the running max and sum in registers (exp2
// domain).  Causal CTAs stop at their diagonal; K/V columns past lens[b] are
// never loaded.  All arithmetic is f32 FMA: the f32 path has no tensor-core
// route at full precision, and wgmma/TMA for bf16 come in a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int LANES_PER_ROW = 4;
constexpr int NUM_THREADS = BLOCK_Q * LANES_PER_ROW;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = raw.x;
  *reinterpret_cast<uint32_t*>(&hi) = raw.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ lens,
               T* __restrict__ o, float* __restrict__ lse, int Lq, int Lk,
               int H, float scale_log2, int causal) {
  // K/V rows per shared-memory tile: 2 tiles * BLOCK_K * D * 4 bytes = 32 KB
  constexpr int BLOCK_K = D >= 128 ? 32 : 64;
  constexpr int ROW4 = D / 4;                // float4 chunks in a head row
  constexpr int CHUNKS = ROW4 / LANES_PER_ROW;  // chunks held by one lane
  __shared__ float4 ks[BLOCK_K][ROW4];
  __shared__ float4 vs[BLOCK_K][ROW4];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int part = threadIdx.x % LANES_PER_ROW;
  const int row = q0 + threadIdx.x / LANES_PER_ROW;
  const bool row_ok = row < Lq;
  const long long stride = static_cast<long long>(H) * D;

  // columns past kv_len are masked; a causal tile never looks past its
  // last row, so the K/V loop stops at kv_end
  const int kv_len = lens ? min(max(lens[b], 0), Lk) : Lk;
  const int kv_end = causal ? min(kv_len, q0 + BLOCK_Q) : kv_len;

  float4 qr[CHUNKS];
  float4 acc[CHUNKS];
  const T* qrow = q + (static_cast<long long>(b) * Lq + row) * stride +
                  static_cast<long long>(h) * D;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok) x = load4(qrow + 4 * (part + LANES_PER_ROW * c));
    qr[c] = make_float4(x.x * scale_log2, x.y * scale_log2, x.z * scale_log2,
                        x.w * scale_log2);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF;  // running max, log2 units
  float l = 0.f;      // running sum of exp2(s - m)

  const long long kv_base = static_cast<long long>(b) * Lk * stride +
                            static_cast<long long>(h) * D;
  for (int k0 = 0; k0 < kv_end; k0 += BLOCK_K) {
    for (int idx = threadIdx.x; idx < BLOCK_K * ROW4; idx += NUM_THREADS) {
      const int j = idx / ROW4;
      const int c4 = idx % ROW4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + j < kv_end) {
        const long long off = kv_base + (k0 + j) * stride + 4 * c4;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      ks[j][c4] = kx;
      vs[j][c4] = vx;
    }
    __syncthreads();

    float s[BLOCK_K];
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const float4 kk = ks[j][part + LANES_PER_ROW * c];
        dot = fmaf(qr[c].x, kk.x, dot);
        dot = fmaf(qr[c].y, kk.y, dot);
        dot = fmaf(qr[c].z, kk.z, dot);
        dot = fmaf(qr[c].w, kk.w, dot);
      }
      s[j] = dot;
    }
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      // the xor butterfly leaves the same full sum in all four lanes
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
      const int col = k0 + j;
      const bool ok = col < kv_end && (!causal || col <= row);
      s[j] = ok ? s[j] : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);  // finite: never below NEG_INF
    const float alpha = exp2f(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      s[j] = exp2f(s[j] - m_new);  // masked: exp2(-inf) = 0
      p_sum += s[j];
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const float4 vv = vs[j][part + LANES_PER_ROW * c];
        acc[c].x = fmaf(s[j], vv.x, acc[c].x);
        acc[c].y = fmaf(s[j], vv.y, acc[c].y);
        acc[c].z = fmaf(s[j], vv.z, acc[c].z);
        acc[c].w = fmaf(s[j], vv.w, acc[c].w);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (!row_ok) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* orow = o + (static_cast<long long>(b) * Lq + row) * stride +
            static_cast<long long>(h) * D;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    store4(orow + 4 * (part + LANES_PER_ROW * c),
           make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv,
                       acc[c].w * inv));
  }
  if (part == 0) {
    lse[(static_cast<long long>(b) * Lq + row) * H + h] =
        l > 0.f ? m * LN2 + logf(l) : NEG_INF;
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const int* lens,
            void* o, float* lse, int B, int Lq, int Lk, int H, float scale,
            int causal, cudaStream_t stream) {
  const dim3 grid((Lq + BLOCK_Q - 1) / BLOCK_Q, H, B);
  fwd_kernel<T, D><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(o), lse, Lq, Lk, H,
      scale * LOG2E, causal);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* lens,
             void* o, float* lse, int B, int Lq, int Lk, int H, int D,
             float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, lens, o, lse, B, Lq, Lk, H, scale, causal, stream); break;
    case 32: launch<T, 32>(q, k, v, lens, o, lse, B, Lq, Lk, H, scale, causal, stream); break;
    case 64: launch<T, 64>(q, k, v, lens, o, lse, B, Lq, Lk, H, scale, causal, stream); break;
    case 128: launch<T, 128>(q, k, v, lens, o, lse, B, Lq, Lk, H, scale, causal, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  Pointers are device pointers of
// contiguous tensors; `lens` may be null.  dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
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
