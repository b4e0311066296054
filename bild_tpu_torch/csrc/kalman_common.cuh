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

}  // namespace bild

extern "C" const char* bild_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
