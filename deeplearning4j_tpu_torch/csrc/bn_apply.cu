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
// Design: bn_stream.cuh's layout. A thread owns one 16-byte unit of
// channels (8 bf16 or 4 f32; one channel where C is not a multiple of that
// or a pointer is not 16-byte aligned) with its mean_b, scale and shift in
// registers, and a block takes an unrolled group of rows: all its
// streaming loads, then the math and the streaming stores.
#include "bn_stream.cuh"

namespace {

using namespace dl4j::bnstream;

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS) bn_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ mean_b,
    const float* __restrict__ scale, const float* __restrict__ shift, T* __restrict__ y,
    Geom g) {
  const Place p = place(g);
  if (p.u < 0) return;
  const int c0 = p.u * V;
  float mb[V], sc[V], sh[V];
  coefficients<V>(mean_b, c0, mb);
  coefficients<V>(scale, c0, sc);
  coefficients<V>(shift, c0, sh);
  for (long long r0 = p.row; r0 < g.M; r0 += sweep(g)) {
    Unit<T, V> in[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long r = r0 + (long long)k * g.rows;
      if (r < g.M) in[k].load(x + r * g.C + c0);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long r = r0 + (long long)k * g.rows;
      if (r < g.M) {
        float v[V];
        in[k].get(v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float t = fmaf(v[i] - mb[i], sc[i], sh[i]);
          if (RELU) t = fmaxf(t, 0.0f);
          v[i] = t;
        }
        Unit<T, V> out;
        out.set(v);
        out.store(y + r * g.C + c0);
      }
    }
  }
}

template <typename T, int V, bool RELU>
int launch_v(const void* x, const void* mb, const void* sc, const void* sh, void* y, int M,
             int C, cudaStream_t stream) {
  const Geom g = geometry(M, C, V);
  bn_apply_kernel<T, V, RELU><<<grid<bn_apply_kernel<T, V, RELU>>(g), g.rows * g.cols, 0,
                                stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mb), static_cast<const float*>(sc),
      static_cast<const float*>(sh), static_cast<T*>(y), g);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* mb, const void* sc, const void* sh, void* y, int M,
           int C, int relu, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec)
    return relu ? launch_v<T, V, true>(x, mb, sc, sh, y, M, C, stream)
                : launch_v<T, V, false>(x, mb, sc, sh, y, M, C, stream);
  return relu ? launch_v<T, 1, true>(x, mb, sc, sh, y, M, C, stream)
              : launch_v<T, 1, false>(x, mb, sc, sh, y, M, C, stream);
}

}  // namespace

// x, y [M, C]; mean_b, scale, shift [C] f32. vec = 1 takes the 16-byte
// units (the wrapper checks C % (16 / sizeof(T)) == 0 and 16-byte
// alignment of x and y). dtype: 0 = f32, 1 = bf16. Returns
// cudaGetLastError() after the launch.
extern "C" int bn_apply(int dtype, const void* x, const void* mean_b, const void* scale,
                        const void* shift, void* y, int M, int C, int relu, int vec,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || C < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, mean_b, scale, shift, y, M, C, relu, vec, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mean_b, scale, shift, y, M, C, relu, vec, s);
  return cudaErrorInvalidValue;
}
