// Shared helpers of the Rouse-Kalman likelihood kernels.
//
// Each kernel source includes this header once and is built into its own
// shared library (see bild_tpu_torch/ops/_build.py), so the C function
// defined here exists once per library.
#pragma once

#include <cuda_runtime.h>

namespace bild {

// threads per block of both kernels: one block evaluates one profile of
// one lane
constexpr int kThreads = 256;
constexpr double kLog2Pi = 1.8378770664093453;  // log(2 pi)
// covariance copies (distinct localization errors) accumulated per pass
// over an operator row in the packed kernel
constexpr int kQChunk = 4;

__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// An out-of-range state reads state 0 or n-1; the wrapper turns that
// profile's result into NaN, so nothing outside the operators is read.
__device__ __forceinline__ int clamp_state(int s, int n) {
  return s < 0 ? 0 : (s >= n ? n - 1 : s);
}

// Allow `smem` bytes of dynamic shared memory for `kernel`, launch it with
// one block per (lane, profile): L * P blocks, block b evaluating profile
// b % P of lane b / P. Returns the launch error code; a grid beyond the x
// dimension's 2^31 - 1 blocks is refused before launching.
template <typename Kernel, typename... Args>
int launch_per_profile(Kernel kernel, int L, int P, size_t smem, int device,
                       void* stream, Args... args) {
  const long long blocks = static_cast<long long>(L) * P;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bild

extern "C" const char* bild_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
