// float <-> storage type conversions shared by the model-zoo kernels
// (segment_spmm.cu, embedding_bag.cu): they load float32 or bfloat16,
// accumulate in float and cast on store.

#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
