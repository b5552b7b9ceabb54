// The batch-norm pullback's two passes over [M, C] (NHWC rows):
//   K7, reduce:  sum_g[c] = sum_m g[m, c]   sum_gx[c] = sum_m g[m, c] * x[m, c]
//   K8, apply:   dx[m, c] = c1[c] * g[m, c] - c3[c] * x[m, c] + c0[c]
// x is the tensor dx is affine in (x - bf16(mean) for bf16, raw x for
// f32); the per-channel coefficients between the passes are plain torch in
// the wrapper, as in the JAX package. Math in f32; sums in f32; dx in g's
// type.
//
// Replaces: deeplearning4j_tpu/ops/pallas_conv_bn.py `_bnb_reduce_call` ->
// `_bnb_reduce_kernel` (K7) and `_bnb_apply_call` -> `_bnb_apply_kernel`
// (K8).
//
// What bounds it on an H100: bytes. K7 reads g and x once (2 * M * C *
// sizeof(T)); K8 reads them again and writes dx (3 * M * C * sizeof(T)).
// At [128*56*56, 256] in bf16 that is 411 MB (0.12 ms) and 617 MB
// (0.18 ms) at 3.35 TB/s.
//
// Design. K7: a block owns 32 channels by 8 row lanes over a fixed chunk
// of rows; warps read 32 neighbouring channels of a row. Lane sums are
// combined in lane order, each chunk writes one partial row, and a second
// launch sums the partial rows in order (conv_bn.cuh `column_sums`). The
// chunking depends on M alone, so the sums are the same bits on every
// launch. K8: bn_apply.cu's vector stream with two inputs.
#include "conv_bn.cuh"

namespace {

using namespace dl4j::convbn;

constexpr int RED_COLS = 32;
constexpr int RED_LANES = 8;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(RED_COLS * RED_LANES) bn_reduce_kernel(
    const T* __restrict__ g, const T* __restrict__ x, float* __restrict__ part_g,
    float* __restrict__ part_gx, int M, int C, int rows_per_chunk) {
  __shared__ float red_g[RED_LANES][RED_COLS], red_gx[RED_LANES][RED_COLS];
  const int cl = threadIdx.x % RED_COLS, l = threadIdx.x / RED_COLS;
  const int c = blockIdx.x * RED_COLS + cl;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(r0 + rows_per_chunk, M);
  float sg = 0.0f, sgx = 0.0f;
  if (c < C) {
    for (int r = r0 + l; r < r1; r += RED_LANES) {
      const float gv = dl4j::to_f32(g[(size_t)r * C + c]);
      sg += gv;
      sgx = fmaf(gv, dl4j::to_f32(x[(size_t)r * C + c]), sgx);
    }
  }
  red_g[l][cl] = sg;
  red_gx[l][cl] = sgx;
  __syncthreads();
  if (l == 0 && c < C) {
    float a = 0.0f, b = 0.0f;
    for (int i = 0; i < RED_LANES; ++i) {
      a += red_g[i][cl];
      b += red_gx[i][cl];
    }
    part_g[(size_t)blockIdx.y * C + c] = a;
    part_gx[(size_t)blockIdx.y * C + c] = b;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) bn_dx_kernel(
    const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ c1,
    const float* __restrict__ c3, const float* __restrict__ c0, T* __restrict__ dx,
    int units, int C) {
  for (int u = blockIdx.x * THREADS + threadIdx.x; u < units; u += gridDim.x * THREADS) {
    const int e = u * V;
    const int cb = e % C;
    float gv[V], xv[V];
    load_f32<T, V>(g + e, gv);
    load_f32<T, V>(x + e, xv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = cb + i;
      gv[i] = c1[c] * gv[i] - c3[c] * xv[i] + c0[c];
    }
    store_from_f32<T, V>(dx + e, gv);
  }
}

template <typename T>
int launch_reduce(const void* g, const void* x, void* sum_g, void* sum_gx, void* part,
                  int M, int C, int chunks, cudaStream_t stream) {
  const int rows = (M + chunks - 1) / chunks;
  float* pg = static_cast<float*>(part);
  float* pgx = pg + (size_t)chunks * C;
  dim3 grid((C + RED_COLS - 1) / RED_COLS, chunks);
  bn_reduce_kernel<T><<<grid, RED_COLS * RED_LANES, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), pg, pgx, M, C, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_column_sums(pg, pgx, static_cast<float*>(sum_g),
                            static_cast<float*>(sum_gx), chunks, C, stream);
}

template <typename T, int V>
int launch_dx(const void* g, const void* x, const void* c1, const void* c3,
              const void* c0, void* dx, int total, int C, cudaStream_t stream) {
  const int units = total / V;
  bn_dx_kernel<T, V><<<stream_blocks(units, THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const float*>(c1),
      static_cast<const float*>(c3), static_cast<const float*>(c0), static_cast<T*>(dx),
      units, C);
  return cudaGetLastError();
}

}  // namespace

// K7. g, x [M, C]; sum_g, sum_gx [C] f32; part: f32 scratch [2, chunks, C].
// dtype: 0 = f32, 1 = bf16. Returns cudaGetLastError() after the launches.
extern "C" int bn_backward_reduce(int dtype, const void* g, const void* x, void* sum_g,
                                  void* sum_gx, void* part, int M, int C, int chunks,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_reduce<float>(g, x, sum_g, sum_gx, part, M, C, chunks, s);
  if (dtype == 1)
    return launch_reduce<__nv_bfloat16>(g, x, sum_g, sum_gx, part, M, C, chunks, s);
  return cudaErrorInvalidValue;
}

// K8. g, x, dx [total / C, C]; c1, c3, c0 [C] f32. vec = 1 takes the
// 8-wide path (the wrapper checks C % 8 == 0 and 16-byte alignment).
// dtype: 0 = f32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int bn_backward_apply(int dtype, const void* g, const void* x, const void* c1,
                                 const void* c3, const void* c0, void* dx, int total,
                                 int C, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch_dx<float, 8>(g, x, c1, c3, c0, dx, total, C, s)
               : launch_dx<float, 1>(g, x, c1, c3, c0, dx, total, C, s);
  if (dtype == 1)
    return vec ? launch_dx<__nv_bfloat16, 8>(g, x, c1, c3, c0, dx, total, C, s)
               : launch_dx<__nv_bfloat16, 1>(g, x, c1, c3, c0, dx, total, C, s);
  return cudaErrorInvalidValue;
}
