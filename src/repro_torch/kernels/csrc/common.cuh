// Shared helpers for the port's kernels: fp32/bf16 load, store and the
// round-trip through the storage type that the reference's
// ``p.astype(v.dtype)`` performs before the PV product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

typedef long long i64;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// value of x after a cast to T and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Raise a kernel's dynamic shared-memory limit when it needs more than
// the 48 KB a launch gets by default.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro
