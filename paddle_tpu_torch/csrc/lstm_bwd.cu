// LSTM recurrence, backward: the Hopper (sm_90a) counterpart of
// paddle_tpu/ops/pallas/lstm.py:_bwd_kernel.
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
// and at the end dh0 = dh_carry, dc0 = dc_carry.  Each block also writes the
// f32 sum of its rows' dgates over all steps (db_part, one row per block):
// the TPU kernel's db sums the f32 dgates, before they round to x's dtype.
//
// lstm_bwd_dw.  dW = sum over (t, b) of h_prev[t, b]^T . dg16[t, b], with
// h_prev = hs[t-1] (h0 at t = 0) read in place through a shifted row index
// and dg16 read back from dx: a [D, T*B] x [T*B, 4D] product with f32 sums.
// The TPU carries dW in VMEM scratch across its sequential grid; here blocks
// run in no order, so a split-K kernel writes one f32 partial per K slice and
// a second kernel sums the slices, and the blocks' db rows, in a fixed order.
// No atomics: the result is the same from run to run.
//
// Design of the walk.  As in the forward kernel, a block owns kRows batch
// rows for all T steps (rows never interact) and thread (g, j) owns the
// (row, unit j) pairs of its group for the elementwise phase; dc stays in its
// registers.  The product dg16 . W^T is done by warps: warp w takes units
// k = w, w + warps, ..., its lanes walk row k of W (consecutive addresses)
// against dg16 kept n-major in shared memory (one 16-byte load gives kRows
// values), and a fixed shuffle tree sums the lanes.  The first rows of W stay
// in shared memory for the whole call; the rest stream from L2 every step.
//
// Bound on the card at B=128, T=64, D=128, f32: the walk's dgates . W^T and
// dW are 2 * 2 * B * T * D * 4D = 2.15 GFLOP (32 us at 67 TFLOP/s) against
// about 51 MB read and written (15 us at 3.35 TB/s); the walk's T dependent
// steps make its real floor latency.
//
// Ragged edges: any B >= 1, T >= 1; a row with m = 0 at a step gets dx = 0
// there and passes dh, dc through; rows past B are masked in the kernels.
// D must be a multiple of 32 in [32, 512].
//
// Plain C interface, bound with ctypes.  Launches on the caller's stream and
// returns cudaGetLastError().  The conversion helpers repeat lstm_fwd.cu's:
// each source builds into its own library, keyed by its own hash.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRows = 4;  // batch rows one block owns (as lstm_fwd.cu)
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;
static_assert(kRows == 4, "dg16 is read as one float4 of kRows rows per n");

// dW tiles: BM x BN outputs, BK deep, 256 threads of 4 x 4 outputs
constexpr int BM = 64, BN = 64, BK = 16;

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
};

template <typename T>
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
                         int d, int groups, int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d4 = 4 * d;
  float* dh_s = reinterpret_cast<float*>(smem);  // [kRows][d]
  float* dg_s = dh_s + kRows * d;                // [4d][kRows], n-major
  float* db_red = dg_s + d4 * kRows;             // [groups][4][d]
  T* w_s = reinterpret_cast<T*>(db_red + groups * 4 * d);  // [resident][4d]

  const int tid = threadIdx.x;
  const int g = tid / d;
  const int j = tid - g * d;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int b0 = blockIdx.x * kRows;

  for (int idx = tid; idx < resident * d4; idx += blockDim.x) w_s[idx] = w[idx];
  for (int idx = tid; idx < kRows * d; idx += blockDim.x) dh_s[idx] = 0.f;
  for (int idx = tid; idx < d4 * kRows; idx += blockDim.x) dg_s[idx] = 0.f;
  float dc_reg[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) dc_reg[q] = 0.f;
  float db_acc[4] = {0.f, 0.f, 0.f, 0.f};
  __syncthreads();

  for (int t = steps - 1; t >= 0; --t) {
    // phase A: elementwise gate gradients of the pairs this thread owns
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = g + q * groups;
      if (r >= kRows) continue;
      const int b = b0 + r;
      if (b >= batch) continue;
      const size_t row = (size_t)t * batch + b;
      const T* a = acts + row * d4 + j;
      const float cand = Cvt<T>::ld(a), ig = Cvt<T>::ld(a + d);
      const float fg = Cvt<T>::ld(a + 2 * d), og = Cvt<T>::ld(a + 3 * d);
      const float c_prev = t > 0 ? __ldg(cs + (row - batch) * d + j)
                                 : __ldg(c0 + (size_t)b * d + j);
      const float c_new = fg * c_prev + ig * cand;
      const float tc = tanhf(c_new);
      const float m = __ldg(mask + row);
      const float dh_tot = Cvt<T>::ld(dhs + row * d + j) + dh_s[r * d + j];
      const float dc_tot = __ldg(dcs + row * d + j) + dc_reg[q];
      const float dh_new = m * dh_tot;
      const float d_o = dh_new * tc;
      const float dc_new = m * dc_tot + dh_new * og * (1.f - tc * tc);
      float dg[4];
      dg[0] = (dc_new * ig) * (1.f - cand * cand);
      dg[1] = (dc_new * cand) * ig * (1.f - ig);
      dg[2] = (dc_new * c_prev) * fg * (1.f - fg);
      dg[3] = d_o * og * (1.f - og);
      T* xo = dx + row * d4 + j;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        xo[gate * d] = Cvt<T>::from_f(dg[gate]);
        dg_s[(gate * d + j) * kRows + r] = Cvt<T>::round(dg[gate]);
        db_acc[gate] += dg[gate];
      }
      dh_s[r * d + j] = (1.f - m) * dh_tot;
      dc_reg[q] = (1.f - m) * dc_tot + dc_new * fg;
    }
    __syncthreads();

    // phase B: dh_carry += dg16 . W^T, one unit k per warp at a time
    for (int k = warp; k < d; k += warps) {
      const T* wr = k < resident ? w_s + (size_t)k * d4 : w + (size_t)k * d4;
      float p[kRows] = {0.f, 0.f, 0.f, 0.f};
      for (int n = lane; n < d4; n += 32) {
        const float wv = Cvt<T>::to_f(wr[n]);
        const float4 gv = *reinterpret_cast<const float4*>(dg_s + n * kRows);
        p[0] = fmaf(gv.x, wv, p[0]);
        p[1] = fmaf(gv.y, wv, p[1]);
        p[2] = fmaf(gv.z, wv, p[2]);
        p[3] = fmaf(gv.w, wv, p[3]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p[r] += __shfl_xor_sync(0xffffffffu, p[r], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) dh_s[r * d + k] += p[r];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = g + q * groups;
    if (r >= kRows) continue;
    const int b = b0 + r;
    if (b >= batch) continue;
    dh0[(size_t)b * d + j] = Cvt<T>::from_f(dh_s[r * d + j]);
    dc0[(size_t)b * d + j] = dc_reg[q];
  }
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
    db_red[(g * 4 + gate) * d + j] = db_acc[gate];
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      float s = 0.f;
      for (int gg = 0; gg < groups; ++gg) s += db_red[(gg * 4 + gate) * d + j];
      db_part[(size_t)blockIdx.x * d4 + gate * d + j] = s;
    }
  }
}

// part[s] = sum over K slice s of h_prev^T . dg16, one BM x BN tile a block
template <typename T>
__global__ void __launch_bounds__(256)
    lstm_dw_partial_kernel(const T* __restrict__ hs, const T* __restrict__ h0,
                           const T* __restrict__ dx, float* __restrict__ part,
                           int k_total, int batch, int d, int k_per) {
  __shared__ float a_s[BK][BM];
  __shared__ float b_s[BK][BN];
  const int d4 = 4 * d;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, s = blockIdx.z;
  const int kbeg = s * k_per;
  const int kend = min(k_total, kbeg + k_per);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  for (int kb = kbeg; kb < kend; kb += BK) {
    for (int e = threadIdx.x; e < BK * BM; e += 256) {
      const int kk = e / BM, mm = e - kk * BM;
      const int krow = kb + kk, m = m0 + mm;
      float v = 0.f;
      if (krow < kend && m < d) {
        // h_prev row (t, b) = h0[b] at t = 0, else hs[t-1, b]
        const T* src = krow < batch ? h0 + (size_t)krow * d
                                    : hs + (size_t)(krow - batch) * d;
        v = Cvt<T>::ld(src + m);
      }
      a_s[kk][mm] = v;
    }
    for (int e = threadIdx.x; e < BK * BN; e += 256) {
      const int kk = e / BN, nn = e - kk * BN;
      const int krow = kb + kk, n = n0 + nn;
      b_s[kk][nn] =
          (krow < kend && n < d4) ? Cvt<T>::ld(dx + (size_t)krow * d4 + n)
                                  : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = b_s[kk][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= d) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx + 16 * jj;
      if (n < d4) part[((size_t)s * d + m) * d4 + n] = acc[i][jj];
    }
  }
}

// dw = sum of the K slices, db = sum of the walk blocks' rows, fixed order
__global__ void lstm_dw_reduce_kernel(const float* __restrict__ part,
                                      const float* __restrict__ db_part,
                                      float* __restrict__ dw,
                                      float* __restrict__ db, int d,
                                      int splits, int walk_blocks) {
  const size_t n_w = (size_t)d * 4 * d;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n_w) {
    float s = 0.f;
    for (int i = 0; i < splits; ++i) s += part[(size_t)i * n_w + idx];
    dw[idx] = s;
  } else if (idx < n_w + 4 * (size_t)d) {
    const size_t n = idx - n_w;
    float s = 0.f;
    for (int i = 0; i < walk_blocks; ++i) s += db_part[(size_t)i * 4 * d + n];
    db[n] = s;
  }
}

template <typename T>
int launch_walk(const void* w, const void* mask, const void* acts,
                const void* cs, const void* c0, const void* dhs,
                const void* dcs, void* dx, void* dh0, void* dc0,
                void* db_part, int steps, int batch, int d,
                cudaStream_t stream) {
  int groups = kMaxThreads / d;
  if (groups < 1) groups = 1;
  const size_t d4 = 4 * (size_t)d;
  const size_t fixed =
      sizeof(float) * ((size_t)kRows * d + d4 * kRows + (size_t)groups * 4 * d);
  size_t resident = (kMaxSmem - fixed) / (d4 * sizeof(T));
  if (resident > (size_t)d) resident = d;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (batch + kRows - 1) / kRows;
  lstm_bwd_walk_kernel<T>
      <<<grid, groups * d, fixed + resident * d4 * sizeof(T), stream>>>(
          static_cast<const T*>(w), static_cast<const float*>(mask),
          static_cast<const T*>(acts), static_cast<const float*>(cs),
          static_cast<const float*>(c0), static_cast<const T*>(dhs),
          static_cast<const float*>(dcs), static_cast<T*>(dx),
          static_cast<T*>(dh0), static_cast<float*>(dc0),
          static_cast<float*>(db_part), steps, batch, d, groups,
          (int)resident);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* hs, const void* h0, const void* dx,
              const void* db_part, void* part, void* dw, void* db, int steps,
              int batch, int d, int splits, cudaStream_t stream) {
  const int k_total = steps * batch;
  int k_per = (k_total + splits - 1) / splits;
  k_per = (k_per + BK - 1) / BK * BK;
  const dim3 grid((4 * d + BN - 1) / BN, (d + BM - 1) / BM, splits);
  lstm_dw_partial_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(hs), static_cast<const T*>(h0),
      static_cast<const T*>(dx), static_cast<float*>(part), k_total, batch, d,
      k_per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)d * 4 * d + 4 * (size_t)d;
  const int walk_blocks = (batch + kRows - 1) / kRows;
  lstm_dw_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(db_part),
      static_cast<float*>(dw), static_cast<float*>(db), d, splits,
      walk_blocks);
  return (int)cudaGetLastError();
}

bool bad_shape(int steps, int batch, int d) {
  return steps < 1 || batch < 1 || d < 32 || d > kMaxThreads || d % 32 != 0;
}

}  // namespace

extern "C" {

// The reverse-time walk.  dtype: 0 float32, 1 bfloat16 (of w, acts, dhs, dx,
// dh0).  db_part is [ceil(batch / kRows), 4d] f32.
int lstm_bwd(const void* w, const void* mask, const void* acts,
             const void* cs, const void* c0, const void* dhs,
             const void* dcs, void* dx, void* dh0, void* dc0, void* db_part,
             int steps, int batch, int d, int dtype, void* stream) {
  if (bad_shape(steps, batch, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_walk<float>(w, mask, acts, cs, c0, dhs, dcs, dx, dh0, dc0,
                              db_part, steps, batch, d, s);
  if (dtype == 1)
    return launch_walk<__nv_bfloat16>(w, mask, acts, cs, c0, dhs, dcs, dx,
                                      dh0, dc0, db_part, steps, batch, d, s);
  return (int)cudaErrorInvalidValue;
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

}  // extern "C"
