// Shared helpers of the repro_torch CUDA kernels: element conversion to and
// from f32, and the C-side error string every library exports.
#pragma once

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// dtype codes passed by the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Opt `kernel` in to `bytes` of dynamic shared memory (needed above 48 KB).
// The attribute is per device, so `done` holds one flag per device ordinal;
// the call is idempotent, so threads that race on a flag only repeat it.
constexpr int kMaxDevices = 64;
template <typename F>
cudaError_t opt_in_smem(F* kernel, int bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && cached) done[dev].store(true, std::memory_order_release);
  return e;
}

}  // namespace repro

#define REPRO_ERROR_STRING_FN(name)                                  \
  extern "C" const char* name##_error_string(int err) {              \
    return cudaGetErrorString(static_cast<cudaError_t>(err));        \
  }
