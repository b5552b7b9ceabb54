// Shared pieces of the port's hand-written kernels: f32 <-> storage-type
// conversion, the LSTM gate nonlinearities, and the C-interface error
// string. Math is always f32; tensors are f32 or bf16 (dtype code 0 / 1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dl4j {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Grid-wide barrier of a cooperative launch: the block's writes,
// __threadfence(), one atomic arrive on a zeroed counter, then a spin until
// `target` arrivals (the n-th barrier waits for n * gridDim.x). Only safe
// when every block is resident, which cudaLaunchCooperativeKernel ensures.
__device__ __forceinline__ void grid_barrier(unsigned int* bar, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(bar) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace dl4j

// Message for an error code a C entry point returned.
extern "C" const char* dl4j_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
