// Device helpers of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): f32 products on the tensor cores in 3xTF32 with
// mma.sync.m16n8k8, and cp.async copies.  flash_attention_fwd.cu's source
// note explains the split and the fragment layouts.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

constexpr uint32_t TF32_MASK = 0xffffe000u;  // sign, exponent, 10 mantissa bits

// x = big + small: big is x rounded to TF32 (to nearest, ties away from 0,
// as cvt.rna), small = x - big (exact in f32) rounded the same way, which
// leaves an error near 2^-23 |x|.  Integer and FADD ops rather than cvt,
// whose conversion unit runs at a quarter of the integer rate.  EXACT: x
// is already TF32 (a widened bf16), small is 0 and never read.
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

struct FragA {
  uint32_t big[4];
  uint32_t small[4];
};

// D += A * B in 3xTF32; the terms with a small part that is 0 by type are
// left out (A_EXACT / B_EXACT).  Small terms first, the big one last.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, uint32_t b0_big,
                                     uint32_t b0_small, uint32_t b1_big,
                                     uint32_t b1_small) {
  if (!A_EXACT) mma(d, a.small, b0_big, b1_big);
  if (!B_EXACT) mma(d, a.big, b0_small, b1_small);
  mma(d, a.big, b0_big, b1_big);
}

// A fragment of a 16 x 8 block at s (row stride STRIDE): a0 = A[g][t],
// a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
template <typename T, int STRIDE, bool EXACT>
__device__ __forceinline__ FragA load_a(const T* s, int g, int t) {
  const float x[4] = {widen(s[g * STRIDE + t]), widen(s[(g + 8) * STRIDE + t]),
                      widen(s[g * STRIDE + t + 4]),
                      widen(s[(g + 8) * STRIDE + t + 4])};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split<EXACT>(x[i], f.big[i], f.small[i]);
  return f;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int src_size = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
