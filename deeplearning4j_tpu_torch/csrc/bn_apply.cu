// Batch-norm apply from precomputed per-channel coefficients, one pass:
//   y = (x - mean_b[c]) * scale[c] + shift[c]      (then max(y, 0) with relu)
// over x [M, C] (NHWC rows), in f32 math, y in x's type. mean_b is the
// batch mean rounded to x's type: x - mean_b is then near the mean's
// rounding-free deviation, and shift carries the rounding error back
// (shift = beta - (mean - mean_b) * scale), as the JAX package's centered
// form does.
//
// Replaces: deeplearning4j_tpu/ops/pallas_conv_bn.py `_norm_call` ->
// `_norm_kernel` / `_norm_kernel_relu` (K6).
//
// What bounds it on an H100: bytes. It reads x once and writes y once,
// 2 * M * C * sizeof(T) bytes: 411 MB in bf16 for [128*56*56, 256], about
// 0.12 ms at 3.35 TB/s, at 3 FLOP per element.
//
// Design: a grid-stride stream of 8-element vectors (16 bytes of bf16,
// two float4 of f32) when C is a multiple of 8 and the pointers are
// 16-byte aligned, one element at a time otherwise. One 32-bit remainder
// per vector gives the channel; the per-channel coefficients are three
// C-float arrays that stay in L1/L2.
#include "conv_bn.cuh"

namespace {

using namespace dl4j::convbn;

constexpr int THREADS = 256;

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS) bn_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ mean_b,
    const float* __restrict__ scale, const float* __restrict__ shift, T* __restrict__ y,
    int units, int C) {
  for (int u = blockIdx.x * THREADS + threadIdx.x; u < units; u += gridDim.x * THREADS) {
    const int e = u * V;
    const int c0 = e % C;
    float v[V];
    load_f32<T, V>(x + e, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = c0 + i;
      float r = (v[i] - mean_b[c]) * scale[c] + shift[c];
      if (RELU) r = fmaxf(r, 0.0f);
      v[i] = r;
    }
    store_from_f32<T, V>(y + e, v);
  }
}

template <typename T, int V>
int launch_v(const void* x, const void* mb, const void* sc, const void* sh, void* y,
             int total, int C, int relu, cudaStream_t stream) {
  const int units = total / V;
  const int blocks = stream_blocks(units, THREADS);
  const T* xp = static_cast<const T*>(x);
  const float* mp = static_cast<const float*>(mb);
  const float* sp = static_cast<const float*>(sc);
  const float* hp = static_cast<const float*>(sh);
  T* yp = static_cast<T*>(y);
  if (relu)
    bn_apply_kernel<T, V, true><<<blocks, THREADS, 0, stream>>>(xp, mp, sp, hp, yp, units, C);
  else
    bn_apply_kernel<T, V, false><<<blocks, THREADS, 0, stream>>>(xp, mp, sp, hp, yp, units, C);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* mb, const void* sc, const void* sh, void* y,
           int total, int C, int relu, int vec, cudaStream_t stream) {
  if (vec) return launch_v<T, 8>(x, mb, sc, sh, y, total, C, relu, stream);
  return launch_v<T, 1>(x, mb, sc, sh, y, total, C, relu, stream);
}

}  // namespace

// x, y [total / C, C]; mean_b, scale, shift [C] f32. vec = 1 takes the
// 8-wide path (the wrapper checks C % 8 == 0 and 16-byte alignment).
// dtype: 0 = f32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int bn_apply(int dtype, const void* x, const void* mean_b, const void* scale,
                        const void* shift, void* y, int total, int C, int relu, int vec,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, mean_b, scale, shift, y, total, C, relu, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mean_b, scale, shift, y, total, C, relu, vec, s);
  return cudaErrorInvalidValue;
}
