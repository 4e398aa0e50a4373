// What the LSTM kernels' thread-block clusters share (lstm_fwd.cu,
// lstm_bwd.cu).  Device side: cp.async copies from global to shared memory,
// shared::cluster addresses, st.async stores into a partner CTA counted on
// its mbarrier, and the mbarrier operations; lstm_bwd.cu's source note
// explains the exchange.  Host side: the launch configuration, the rule that
// picks the cluster size, and the launch that refuses a cluster the card
// cannot place.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// global to shared (address d) copies; a copy that is not valid fills its
// bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t d, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t d, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst)), src, valid);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of this CTA's shared address a in CTA rank
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(a), "r"(rank));
  return out;
}

// 16 bytes into a cluster CTA's shared memory; their arrival completes 16
// bytes of the transaction count of that CTA's mbarrier at bar
__device__ __forceinline__ void st_async16(uint32_t dst, float4 v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival on bar that also expects `bytes` more of transactions
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// until the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// --- host side --------------------------------------------------------------

constexpr int kMaxSmem = 232448;  // shared memory one CTA may use, sm_90
constexpr int kMaxCluster = 8;    // the portable cluster size

// What a kernel's plan makes of clusters of n CTAs
constexpr int kRefused = -1;  // it does not take n
constexpr int kStreams = 0;   // it takes n; some of W's rows stream from L2
constexpr int kHolds = 1;     // it takes n; the CTAs hold all of W

// A launch of a cluster kernel: the kernel, its plan (which has `threads`
// and `smem`, the dynamic shared memory of a CTA) and its configuration,
// whose cluster attribute points into the struct (hence no copies).
template <typename Kernel, typename Plan>
struct ClusterLaunch {
  Kernel kernel;
  Plan plan;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;

  ClusterLaunch() = default;
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;

  // A 1-D grid of `clusters` clusters of n CTAs.  Above 48 KB a CTA's
  // dynamic shared memory has to be asked for, once for each device and
  // kernel: *asked keeps one bit a device.
  cudaError_t configure(int clusters, int n, cudaStream_t stream,
                        std::atomic<uint64_t>* asked) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (!(asked->load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return err;
      asked->fetch_or(bit, std::memory_order_relaxed);
    }
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)n;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3((unsigned)(clusters * n));
    cfg.blockDim = dim3((unsigned)plan.threads);
    cfg.dynamicSmemBytes = plan.smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaSuccess;
  }

  // the clusters the card can hold at once (0: none, or an error)
  int placed() const {
    int m = 0;
    return cudaOccupancyMaxActiveClusters(&m, kernel, &cfg) == cudaSuccess
               ? m
               : 0;
  }

  // The launch; a cluster the card cannot place is an error, never a
  // smaller cluster.  Returns a cudaError_t.
  template <typename... Args>
  int launch(Args... args) const {
    int max_clusters = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveClusters(&max_clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (max_clusters < 1) return (int)cudaErrorInvalidConfiguration;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
};

// The cluster size a kernel launches with where the caller names none.
// fit(n) is the plan's verdict on clusters of n (kRefused, kStreams or
// kHolds); placed(n) the clusters of n the card holds at once.  The
// smallest n whose CTAs hold all of W, else the largest n the plan takes;
// then doubled while the plan takes the doubled size and its grid still
// runs in one wave: every cluster placed at once, no more CTAs than SMs.
// (A card places a cluster within one GPC, so fewer clusters of 4 CTAs of
// 16 warps fit on the H100 at once than its SMs hold CTAs.)  Negative if
// the plan takes no size, or on an error.
template <typename Fit, typename Placed>
int choose_cluster(int clusters, Fit fit, Placed placed) {
  int sms = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  int n = -1;
  for (int m = 1; m <= kMaxCluster; m *= 2) {
    const int f = fit(m);
    if (f == kHolds) {
      n = m;
      break;
    }
    if (f == kStreams) n = m;
  }
  if (n < 1) return -1;
  while (2 * n <= kMaxCluster && fit(2 * n) != kRefused &&
         (long long)clusters * 2 * n <= sms && placed(2 * n) >= clusters)
    n *= 2;
  return n;
}

// choose(batch, d, dtype) for the current device; the answer for the last
// (device, batch, d, dtype) this thread asked is kept
template <typename Choose>
int cached_cluster(int batch, int d, int dtype, Choose choose) {
  static thread_local int last[5] = {-1, 0, 0, 0, 0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (last[0] == dev && last[1] == batch && last[2] == d && last[3] == dtype)
    return last[4];
  const int n = choose(batch, d, dtype);
  if (n > 0) {
    last[0] = dev;
    last[1] = batch;
    last[2] = d;
    last[3] = dtype;
    last[4] = n;
  }
  return n;
}

}  // namespace
