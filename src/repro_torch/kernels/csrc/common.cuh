// Helpers shared by the port's CUDA sources: conversions between the
// storage types and the float32 the kernels compute in, and the error
// message entry point each library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round a float32 to the storage type once, to nearest even.
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Defines `const char* PREFIX_error_string(int code)`: the message of the
// cudaError_t a launch entry point returned. Expand inside `extern "C"`.
#define REPRO_ERROR_STRING(PREFIX)                  \
  const char* PREFIX##_error_string(int code) {     \
    return cudaGetErrorString((cudaError_t)code);   \
  }
