// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
//
// Every exported launcher has a plain C interface (bound with ctypes from
// stgcma_tpu_torch/ops/cuda_lib.py), launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() right after the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define STG_API extern "C" __attribute__((visibility("default")))

STG_API const char* stg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
