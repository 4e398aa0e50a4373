// Flash-attention backward for Hopper (sm_90a), CUDA C++: the dQ kernel and
// the dK/dV kernel.
//
// Replaces the Pallas TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// `_dq_kernel` and `_dkv_kernel` (launched by `_bwd_impl` through
// pallas_call).  With S = scale * Q K^T, P = exp(S - LSE) recomputed from the
// forward's log-sum-exp (masked entries exactly 0), dP = dO V^T and
// delta = rowsum(dO * O) (computed by the caller, f32 [B, Lq, H]):
//
//   dS = P * (dP - delta)
//   dQ = scale * dS K          (dq_kernel: one CTA per Q tile)
//   dK = scale * dS^T Q        (dkv_kernel: one CTA per K tile)
//   dV = P^T dO
//
// As in the TPU version the split keeps each output row owned by one CTA,
// so nothing needs atomics.  Masking is the forward's: column j is masked
// when j >= lens[b] (lens absent: Lk) and, when causal, when j > i in
// absolute top-left-aligned indices, also when Lq != Lk.  The mask is applied
// before the exponential (a masked entry computes exp2(-inf) = 0), so a fully
// masked row (LSE = -1e30) never forms exp(s + 1e30): its dQ is 0, and K/V
// rows that no query row sees get dK = dV = 0.
//
// Layout: q/dO [B, Lq, H*D], k/v [B, Lk, H*D], row-major and contiguous;
// each head is a D-wide column slice read in place.  LSE and delta are
// [B, Lq, H] f32.  Nothing is padded in device memory: the JAX version pads
// Lq and Lk to its block and relies on padded dO rows being 0; here dK/dV
// masks Q rows >= Lq and dQ masks K columns >= min(lens, Lk) themselves.
//
// What bounds it on this card.  At the Transformer-base shape (B=16, H=8,
// L=256, D=64, f32, non-causal) dQ does three products (S again, dP, dQ),
// 6*B*H*L*L*D = 3.2 GFLOP, and moves q, k, v, dO, dQ plus LSE and delta,
// about 42 MB; dK/dV does four (S, dP, dV, dK), 4.3 GFLOP, and moves about
// 50 MB.  At 67 TFLOP/s f32 (no tensor cores at full precision) against
// 3.35 TB/s that is 48 and 64 us of arithmetic against 13 and 15 us of
// traffic: both are operation-bound.
//
// Design.  The forward's: 256 threads, several neighbouring lanes share one
// output row and each holds a slice of that row's operands and accumulators
// in registers, in 16-byte chunks interleaved so that the lanes of a row
// read one contiguous run of a shared-memory row while the other rows of the
// warp read the same address (a broadcast).  Per streamed row, each lane
// forms partial dot products and xor-shuffles complete them; all arithmetic
// is f32 FMA.
//
// - dq_kernel: a CTA holds 64 Q rows (4 lanes each: q pre-scaled by
//   scale*log2(e), dO, and the dQ accumulator) and streams K/V tiles through
//   shared memory up to min(lens, Lk) -- up to its diagonal when causal.
// - dkv_kernel: a CTA holds 64 K rows (32 at D=128) with k, v and the two
//   accumulators dK, dV, and streams Q/dO tiles (with their LSE and delta)
//   through shared memory from the first Q row that can see the tile (its
//   first K row when causal) to Lq.  Two accumulators per row would need 2*D
//   registers a lane at four lanes a row; at D=128 a row gets eight lanes,
//   so a lane keeps 16 floats of each of k, v, dK and dV.
// No wgmma/TMA yet: that is later work, as for the forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NUM_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// sum over the LANES neighbouring lanes of a row; every lane gets the sum
template <int LANES>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < LANES; m *= 2) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ lens, T* __restrict__ dq, int Lq,
              int Lk, int H, float scale, int causal) {
  constexpr int LANES = 4;
  constexpr int BLOCK_Q = NUM_THREADS / LANES;
  // K/V rows per shared-memory tile: 2 tiles * BLOCK_K * D * 4 bytes = 32 KB
  constexpr int BLOCK_K = D >= 128 ? 32 : 64;
  constexpr int ROW4 = D / 4;            // float4 chunks in a head row
  constexpr int CHUNKS = ROW4 / LANES;   // chunks held by one lane
  __shared__ float4 ks[BLOCK_K][ROW4];
  __shared__ float4 vs[BLOCK_K][ROW4];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK_Q;
  const int part = threadIdx.x % LANES;
  const int row = q0 + threadIdx.x / LANES;
  const bool row_ok = row < Lq;
  const long long stride = static_cast<long long>(H) * D;

  // columns past kv_len are masked; a causal tile never looks past its last
  // row, so the K/V loop stops at kv_end
  const int kv_len = lens ? min(max(lens[b], 0), Lk) : Lk;
  const int kv_end = causal ? min(kv_len, q0 + BLOCK_Q) : kv_len;

  const float scale_log2 = scale * LOG2E;
  const long long qoff = (static_cast<long long>(b) * Lq + row) * stride +
                         static_cast<long long>(h) * D;
  float4 qr[CHUNKS], dor[CHUNKS], acc[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = x;
    if (row_ok) {
      x = load4(q + qoff + 4 * (part + LANES * c));
      y = load4(dout + qoff + 4 * (part + LANES * c));
    }
    qr[c] = scale4(x, scale_log2);
    dor[c] = y;
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const long long rowh = (static_cast<long long>(b) * Lq + row) * H + h;
  const float lse2 = row_ok ? lse[rowh] * LOG2E : 0.f;  // log2 units
  const float dl = row_ok ? delta[rowh] : 0.f;

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

#pragma unroll 8
    for (int j = 0; j < BLOCK_K; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        s = dot4(qr[c], ks[j][part + LANES * c], s);
        dp = dot4(dor[c], vs[j][part + LANES * c], dp);
      }
      s = row_sum<LANES>(s);
      dp = row_sum<LANES>(dp);
      const int col = k0 + j;
      const bool ok = row_ok && col < kv_end && (!causal || col <= row);
      const float p = exp2f(ok ? s - lse2 : -INFINITY);  // masked: exactly 0
      const float ds = p * (dp - dl);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) axpy4(ds, ks[j][part + LANES * c], acc[c]);
    }
    __syncthreads();
  }

  if (!row_ok) return;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
    store4(dq + qoff + 4 * (part + LANES * c), scale4(acc[c], scale));
}

template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ lens, T* __restrict__ dk,
               T* __restrict__ dv, int Lq, int Lk, int H, float scale,
               int causal) {
  // lanes per K row: each holds D/LANES floats of k, v, dK and dV
  constexpr int LANES = D >= 128 ? 8 : 4;
  constexpr int BLOCK_KV = NUM_THREADS / LANES;
  // Q/dO rows per shared-memory tile: 2 tiles * BLOCK_Q * D * 4 bytes = 32 KB
  constexpr int BLOCK_Q = D >= 128 ? 32 : 64;
  constexpr int ROW4 = D / 4;
  constexpr int CHUNKS = ROW4 / LANES;
  __shared__ float4 qs[BLOCK_Q][ROW4];
  __shared__ float4 dos[BLOCK_Q][ROW4];
  __shared__ float lse_s[BLOCK_Q];    // log2 units
  __shared__ float delta_s[BLOCK_Q];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k_start = blockIdx.x * BLOCK_KV;
  const int part = threadIdx.x % LANES;
  const int krow = k_start + threadIdx.x / LANES;
  const long long stride = static_cast<long long>(H) * D;
  const long long koff = (static_cast<long long>(b) * Lk + krow) * stride +
                         static_cast<long long>(h) * D;

  const int kv_len = lens ? min(max(lens[b], 0), Lk) : Lk;
  const bool col_ok = krow < kv_len;  // a masked column gets dK = dV = 0

  const float scale_log2 = scale * LOG2E;
  float4 kr[CHUNKS], vr[CHUNKS], dka[CHUNKS], dva[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = x;
    if (col_ok) {
      x = load4(k + koff + 4 * (part + LANES * c));
      y = load4(v + koff + 4 * (part + LANES * c));
    }
    kr[c] = scale4(x, scale_log2);
    vr[c] = y;
    dka[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[c] = dka[c];
  }

  // no Q row before the tile's first K row sees it when causal; a tile
  // wholly past kv_len sees no Q row at all
  const int q_lo = causal ? k_start : 0;
  const int q_end = k_start < kv_len ? Lq : 0;
  const long long q_base = static_cast<long long>(b) * Lq * stride +
                           static_cast<long long>(h) * D;
  for (int qb = q_lo; qb < q_end; qb += BLOCK_Q) {
    for (int idx = threadIdx.x; idx < BLOCK_Q * ROW4; idx += NUM_THREADS) {
      const int i = idx / ROW4;
      const int c4 = idx % ROW4;
      float4 qx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 dx = qx;
      if (qb + i < Lq) {
        const long long off = q_base + (qb + i) * stride + 4 * c4;
        qx = load4(q + off);
        dx = load4(dout + off);
      }
      qs[i][c4] = qx;
      dos[i][c4] = dx;
    }
    for (int i = threadIdx.x; i < BLOCK_Q; i += NUM_THREADS) {
      const bool in = qb + i < Lq;
      const long long rowh = (static_cast<long long>(b) * Lq + qb + i) * H + h;
      lse_s[i] = in ? lse[rowh] * LOG2E : 0.f;
      delta_s[i] = in ? delta[rowh] : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int i = 0; i < BLOCK_Q; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        s = dot4(kr[c], qs[i][part + LANES * c], s);
        dp = dot4(vr[c], dos[i][part + LANES * c], dp);
      }
      s = row_sum<LANES>(s);
      dp = row_sum<LANES>(dp);
      const int qrow = qb + i;
      const bool ok = col_ok && qrow < Lq && (!causal || krow <= qrow);
      const float p = exp2f(ok ? s - lse_s[i] : -INFINITY);  // masked: 0
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        axpy4(p, dos[i][part + LANES * c], dva[c]);
        axpy4(ds, qs[i][part + LANES * c], dka[c]);
      }
    }
    __syncthreads();
  }

  if (krow >= Lk) return;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    store4(dk + koff + 4 * (part + LANES * c), scale4(dka[c], scale));
    store4(dv + koff + 4 * (part + LANES * c), dva[c]);
  }
}

template <typename T, int D>
void launch_dq(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* lens,
               void* dq, int B, int Lq, int Lk, int H, float scale,
               int causal, cudaStream_t stream) {
  constexpr int BLOCK_Q = NUM_THREADS / 4;
  const dim3 grid((Lq + BLOCK_Q - 1) / BLOCK_Q, H, B);
  dq_kernel<T, D><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      lens, static_cast<T*>(dq), Lq, Lk, H, scale, causal);
}

template <typename T, int D>
void launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const int* lens,
                void* dk, void* dv, int B, int Lq, int Lk, int H, float scale,
                int causal, cudaStream_t stream) {
  constexpr int BLOCK_KV = NUM_THREADS / (D >= 128 ? 8 : 4);
  const dim3 grid((Lk + BLOCK_KV - 1) / BLOCK_KV, H, B);
  dkv_kernel<T, D><<<grid, NUM_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      lens, static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, H, scale,
      causal);
}

#define FA_BWD_SWITCH_D(D, CALL)                       \
  switch (D) {                                         \
    case 16: { constexpr int HD = 16; CALL; } break;   \
    case 32: { constexpr int HD = 32; CALL; } break;   \
    case 64: { constexpr int HD = 64; CALL; } break;   \
    case 128: { constexpr int HD = 128; CALL; } break; \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const int* lens,
                void* dq, int B, int Lq, int Lk, int H, int D, float scale,
                int causal, cudaStream_t s) {
  FA_BWD_SWITCH_D(D, (launch_dq<T, HD>(q, k, v, dout, lse, delta, lens, dq, B,
                                       Lq, Lk, H, scale, causal, s)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const int* lens, void* dk, void* dv, int B, int Lq, int Lk,
                 int H, int D, float scale, int causal, cudaStream_t s) {
  FA_BWD_SWITCH_D(D, (launch_dkv<T, HD>(q, k, v, dout, lse, delta, lens, dk,
                                        dv, B, Lq, Lk, H, scale, causal, s)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes.  Pointers are device pointers of
// contiguous tensors; `lens` may be null.  dtype: 0 = float32, 1 = bfloat16
// (q, k, v, dout and the outputs; lse and delta are always float32).
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* lens,
                                  void* dq, int B, int Lq, int Lk, int H,
                                  int D, float scale, int causal, int dtype,
                                  void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* n = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq<float>(q, k, v, dout, l, dl, n, dq, B, Lq, Lk, H, D, scale, causal, s);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(q, k, v, dout, l, dl, n, dq, B, Lq, Lk, H, D, scale, causal, s);
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
