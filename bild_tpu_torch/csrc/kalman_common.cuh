// Shared helpers of the Rouse-Kalman likelihood kernels.
//
// Each kernel source includes this header once and is built into its own
// shared library (see bild_tpu_torch/ops/_build.py), so the C function
// defined here exists once per library.
#pragma once

#include <cuda_runtime.h>

namespace bild {

constexpr double kLog2Pi = 1.8378770664093453;  // log(2 pi)

__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }

// 16-byte vectors: the widest load or store of one thread
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; static constexpr int width = 4; };
template <> struct Vec16<double> { using type = double2; static constexpr int width = 2; };

template <typename T>
__device__ __forceinline__ typename Vec16<T>::type load16(const T* p) {
  return *reinterpret_cast<const typename Vec16<T>::type*>(p);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const T (&v)[Vec16<T>::width]) {
  typename Vec16<T>::type x;
  T* xs = reinterpret_cast<T*>(&x);
#pragma unroll
  for (int u = 0; u < Vec16<T>::width; ++u) xs[u] = v[u];
  *reinterpret_cast<typename Vec16<T>::type*>(p) = x;
}

// An out-of-range state reads state 0 or n-1; the wrapper turns that
// profile's result into NaN, so nothing outside the operators is read.
__device__ __forceinline__ int clamp_state(int s, int n) {
  return s < 0 ? 0 : (s >= n ? n - 1 : s);
}

// Hopper bulk copies (TMA without a tensor map) and the shared-memory
// barriers (mbarrier) that report their completion.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// a barrier that completes when one thread has arrived and its expected
// bytes have landed
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::);
}
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
// copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; completion counts on `bar`. The caller
// overwrites only a buffer whose every read has fed arithmetic before a
// block barrier that precedes the copy.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Correctly rounded product and difference: never contracted into an FMA,
// so an element's bits do not depend on which loop computed it.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// Allow `smem` bytes of dynamic shared memory for `kernel` and launch
// `blocks` blocks of `threads` threads on `stream`. Returns the launch
// error code; a grid beyond the x dimension's 2^31 - 1 blocks is refused
// before launching.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long blocks, int threads, size_t smem,
           int device, void* stream, Args... args) {
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Thread block clusters: the rank of this block in its cluster, the
// cluster address of the same shared variable in block `rank` (distributed
// shared memory), an asynchronous store there, and the cluster barrier
// (every thread of every block arrives; the writes before it are seen
// after it).
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// store v at cluster address `addr`; its 8 bytes count as complete_tx on
// the barrier at cluster address `bar` (in the same block as addr)
__device__ __forceinline__ void st_async(unsigned addr, double v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, [%2];\n"
               ::"r"(addr), "d"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The attributes of a cluster launch of `kernel`: `smem` bytes of dynamic
// shared memory, and clusters above the portable 8 blocks allowed.
template <typename Kernel>
cudaError_t cluster_attributes(Kernel kernel, int cluster, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess || cluster <= 8) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

inline cudaLaunchConfig_t cluster_config(long long blocks, int threads, size_t smem,
                                         void* stream, cudaLaunchAttribute* attr,
                                         int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// launch() for a kernel in clusters of `cluster` blocks (`blocks` a
// multiple of it), through cudaLaunchKernelEx. A refused launch returns
// its error; it never falls back to a launch without clusters.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), long long blocks, int cluster, int threads,
                   size_t smem, int device, void* stream, Args... args) {
  if (blocks > 2147483647LL || cluster < 1 || blocks % cluster != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cluster_attributes(kernel, cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(blocks, threads, smem, stream, &attr, cluster);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` blocks of `kernel` (each `threads`
// threads and `smem` bytes of dynamic shared memory) the device holds at
// once (cudaOccupancyMaxActiveClusters), or minus the error code.
template <typename Kernel>
int max_active_clusters(Kernel kernel, int cluster, int threads, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cluster_attributes(kernel, cluster, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, threads, smem, nullptr, &attr, cluster);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, reinterpret_cast<const void*>(kernel), &cfg);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

}  // namespace bild

extern "C" const char* bild_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
