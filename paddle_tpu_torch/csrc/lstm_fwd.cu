// LSTM recurrence, forward: the Hopper (sm_90a) counterpart of
// paddle_tpu/ops/pallas/lstm.py:_fwd_kernel.
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
// Design.  The TPU kernel walks a (batch_blocks, T) grid in order and keeps
// h and c in VMEM across grid steps.  Here batch rows never interact, so one
// block owns kRows batch rows for all T steps and walks T in a loop: no
// block ever waits for another.  Thread (g, j) of a block owns hidden unit j
// for the k-range of group g (threads = groups * D <= 512), so the four gate
// columns j, D+j, 2D+j, 3D+j of W meet in one thread and a warp's reads of a
// W row are consecutive.  Each step has two phases split by __syncthreads:
//   1. partial products over the group's k-range, h read from shared memory
//      (k-major, so one 16-byte load gives the kRows values of one k), W
//      read from its shared-memory copy where it fits, else from L2;
//   2. the gate math of (row, unit) pairs, group partials summed in fixed
//      order, c kept in registers of the thread that owns the pair, the new
//      h written back to shared memory in place (only its owner reads it in
//      this phase).
// Bound on the card: 2 * B * T * D * 4D FLOP of f32 FMAs (1.07 GFLOP at
// B=128, T=64, D=128 is 16 us at 67 TFLOP/s) against 42 MB of inputs and
// outputs (12.6 us at 3.35 TB/s).  But the T steps are dependent, so each
// step's latency adds up: what the block can do is keep W close.  W is 256 KB
// in f32 at D=128, more than the 227 KB a block may use, so the first rows of
// each group's k-range stay in shared memory for the whole call (gate-
// interleaved, one 16-byte load per k) and the rest stream from L2 every
// step; in bf16 at D=128 all of W stays in shared memory.
//
// Ragged edges: any B >= 1 and T >= 1; rows past B are masked in the kernel,
// never padded.  D must be a multiple of 32 in [32, 512].
//
// Plain C interface, bound with ctypes.  Launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRows = 4;            // batch rows one block owns
constexpr int kMaxThreads = 512;    // groups * D
constexpr int kMaxSmem = 232448;    // shared memory one block may use, sm_90
static_assert(kRows == 4, "h is read as one float4 of kRows rows per k");

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float ld(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  // four consecutive elements from shared memory
  static __device__ __forceinline__ float4 lds4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
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
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

struct Plan {
  int groups;    // k-groups: threads = groups * d
  int chunk;     // k-range of one group
  int resident;  // rows of each group's k-range kept in shared memory
  size_t smem;   // dynamic shared memory bytes
};

template <typename T>
Plan plan_for(int d) {
  Plan p;
  p.groups = kMaxThreads / d;
  if (p.groups < 1) p.groups = 1;
  p.chunk = (d + p.groups - 1) / p.groups;
  const size_t fixed =
      sizeof(float) * (size_t)kRows * d * (1 + (p.groups > 1 ? 4 * p.groups : 0));
  const size_t per_row = (size_t)p.groups * 4 * d * sizeof(T);
  size_t rows = (kMaxSmem - fixed) / per_row;
  if (rows > (size_t)p.chunk) rows = p.chunk;
  p.resident = (int)rows;
  p.smem = fixed + rows * per_row;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_fwd_kernel(const T* __restrict__ xs, const T* __restrict__ w,
                    const float* __restrict__ bias, const T* __restrict__ h0,
                    const float* __restrict__ c0,
                    const float* __restrict__ mask, T* __restrict__ hs,
                    float* __restrict__ cs, T* __restrict__ acts, int steps,
                    int batch, int d, int groups, int chunk, int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d4 = 4 * d;
  float* h_s = reinterpret_cast<float*>(smem);  // [d][kRows], k-major
  float* red = h_s + kRows * d;                 // [groups][4][kRows][d]
  T* w_s = reinterpret_cast<T*>(red + (groups > 1 ? groups * 4 * kRows * d : 0));
  // w_s: [groups][resident][d][4]: row k0 + i of group g, unit j, gate q

  const int tid = threadIdx.x;
  const int g = tid / d;
  const int j = tid - g * d;
  const int b0 = blockIdx.x * kRows;
  const int k0 = g * chunk;
  const int k1 = min(d, k0 + chunk);
  const int kres = min(k1, k0 + resident);

  for (int idx = tid; idx < groups * resident * d4; idx += blockDim.x) {
    const int gi = idx / (resident * d4);
    const int rem = idx - gi * resident * d4;
    const int i = rem / d4;
    const int jq = rem - i * d4;  // j * 4 + q
    const int k = gi * chunk + i;
    if (k < min(d, gi * chunk + chunk))
      w_s[idx] = w[(size_t)k * d4 + (jq & 3) * d + (jq >> 2)];
  }

  const float bc = __ldg(bias + j), bi = __ldg(bias + d + j);
  const float bf = __ldg(bias + 2 * d + j), bo = __ldg(bias + 3 * d + j);
  float c_reg[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = g + q * groups;
    c_reg[q] = 0.f;
    if (r < kRows) {
      const int b = b0 + r;
      const bool live = b < batch;
      h_s[j * kRows + r] = live ? Cvt<T>::ld(h0 + (size_t)b * d + j) : 0.f;
      c_reg[q] = live ? __ldg(c0 + (size_t)b * d + j) : 0.f;
    }
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    float acc[4][kRows];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[q][r] = 0.f;

    // phase 1: partial products h . W over this group's k-range
    const T* wrow = w_s + ((size_t)g * resident) * d4 + 4 * j;
    for (int k = k0; k < kres; ++k, wrow += d4) {
      const float4 wv = Cvt<T>::lds4(wrow);
      const float4 hv = *reinterpret_cast<const float4*>(h_s + k * kRows);
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[0][r] = fmaf(hr[r], wv.x, acc[0][r]);
        acc[1][r] = fmaf(hr[r], wv.y, acc[1][r]);
        acc[2][r] = fmaf(hr[r], wv.z, acc[2][r]);
        acc[3][r] = fmaf(hr[r], wv.w, acc[3][r]);
      }
    }
#pragma unroll 4
    for (int k = kres; k < k1; ++k) {
      const T* wg = w + (size_t)k * d4 + j;
      const float w0 = Cvt<T>::ld(wg), w1 = Cvt<T>::ld(wg + d);
      const float w2 = Cvt<T>::ld(wg + 2 * d), w3 = Cvt<T>::ld(wg + 3 * d);
      const float4 hv = *reinterpret_cast<const float4*>(h_s + k * kRows);
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[0][r] = fmaf(hr[r], w0, acc[0][r]);
        acc[1][r] = fmaf(hr[r], w1, acc[1][r]);
        acc[2][r] = fmaf(hr[r], w2, acc[2][r]);
        acc[3][r] = fmaf(hr[r], w3, acc[3][r]);
      }
    }
    if (groups > 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          red[((g * 4 + q) * kRows + r) * d + j] = acc[q][r];
    }
    __syncthreads();

    // phase 2: gate math of the (row, unit) pairs this thread owns
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = g + q * groups;
      if (r >= kRows) continue;
      const int b = b0 + r;
      if (b >= batch) continue;
      float dot[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        if (groups > 1) {
          float s = 0.f;
          for (int gg = 0; gg < groups; ++gg)
            s += red[((gg * 4 + gate) * kRows + r) * d + j];
          dot[gate] = s;
        } else {
          dot[gate] = acc[gate][q];
        }
      }
      const size_t row = (size_t)t * batch + b;
      const T* xr = xs + row * d4 + j;
      const float gc = Cvt<T>::ld(xr) + dot[0] + bc;
      const float gi = Cvt<T>::ld(xr + d) + dot[1] + bi;
      const float gf = Cvt<T>::ld(xr + 2 * d) + dot[2] + bf;
      const float go = Cvt<T>::ld(xr + 3 * d) + dot[3] + bo;
      const float ig = sigmoid_f(gi), fg = sigmoid_f(gf), og = sigmoid_f(go);
      const float cand = tanhf(gc);
      const float c_new = fg * c_reg[q] + ig * cand;
      const float h_new = og * tanhf(c_new);
      const float m = __ldg(mask + row);
      const float h_out =
          Cvt<T>::round(m * h_new + (1.f - m) * h_s[j * kRows + r]);
      const float c_out = m * c_new + (1.f - m) * c_reg[q];
      h_s[j * kRows + r] = h_out;
      c_reg[q] = c_out;
      hs[row * d + j] = Cvt<T>::from_f(h_out);
      cs[row * d + j] = c_out;
      if (acts != nullptr) {
        T* a = acts + row * d4 + j;
        a[0] = Cvt<T>::from_f(cand);
        a[d] = Cvt<T>::from_f(ig);
        a[2 * d] = Cvt<T>::from_f(fg);
        a[3 * d] = Cvt<T>::from_f(og);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* xs, const void* w, const void* bias, const void* h0,
           const void* c0, const void* mask, void* hs, void* cs, void* acts,
           int steps, int batch, int d, cudaStream_t stream) {
  const Plan p = plan_for<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (batch + kRows - 1) / kRows;
  lstm_fwd_kernel<T><<<grid, p.groups * d, p.smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const T*>(h0),
      static_cast<const float*>(c0), static_cast<const float*>(mask),
      static_cast<T*>(hs), static_cast<float*>(cs), static_cast<T*>(acts),
      steps, batch, d, p.groups, p.chunk, p.resident);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (of xs, w, h0, hs, acts).  acts may be null.
// Returns a cudaError_t; 1 (invalid value) for shapes the kernel does not
// take.
int lstm_fwd(const void* xs, const void* w, const void* bias, const void* h0,
             const void* c0, const void* mask, void* hs, void* cs, void* acts,
             int steps, int batch, int d, int dtype, void* stream) {
  if (steps < 1 || batch < 1 || d < 32 || d > kMaxThreads || d % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xs, w, bias, h0, c0, mask, hs, cs, acts, steps,
                         batch, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xs, w, bias, h0, c0, mask, hs, cs, acts,
                                 steps, batch, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
