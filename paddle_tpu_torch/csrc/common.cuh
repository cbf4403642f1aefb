// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library exposes plain C functions (no PyTorch headers, so
// nvcc builds each file in seconds); the Python wrappers pass raw device
// pointers, the stream, and a dtype code, and check the returned
// cudaError_t value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

// dtype codes shared with paddle_tpu_torch/ops/cuda/_build.py (DTYPE_CODES)
enum DTypeCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Whether every pointer starts on a 16-byte boundary, as kernels that copy
// in 16-byte pieces need (the wrappers check it or guarantee it).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

// Runs `body` with `T` bound to the element type named by `code`; an unknown
// code returns cudaErrorInvalidValue from the enclosing function.
#define DISPATCH_DTYPE(code, T, ...)                 \
  switch (code) {                                    \
    case kF32: {                                     \
      using T = float;                               \
      __VA_ARGS__;                                   \
      break;                                         \
    }                                                \
    case kBF16: {                                    \
      using T = __nv_bfloat16;                       \
      __VA_ARGS__;                                   \
      break;                                         \
    }                                                \
    case kF16: {                                     \
      using T = __half;                              \
      __VA_ARGS__;                                   \
      break;                                         \
    }                                                \
    default:                                         \
      return (int)cudaErrorInvalidValue;             \
  }
