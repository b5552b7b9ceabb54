// A 1x1 convolution as a product, with the batch-norm statistics epilogue:
//   y = x @ w              x [M, Cin] (NHWC rows), w [Cin, Cout] (HWIO 1x1)
//   s1[c] = sum_m y[m, c]  s2[c] = sum_m y[m, c]^2
// with the sums taken over y as stored (rounded to y's type), in f32.
// A stride-2 1x1 conv arrives here as the caller's x[:, ::2, ::2, :].
//
// Replaces: deeplearning4j_tpu/ops/pallas_conv_bn.py `_mm_stats_call` ->
// `_mm_stats_kernel` (K4).
//
// What bounds it on an H100: the product. At ResNet-50's largest 1x1
// instance at batch 128 (64 -> 256 on 56x56, M = 401,408), the function
// moves about 257 MB in bf16 (0.077 ms at 3.35 TB/s) and does 13.2 GFLOP
// (0.013 ms on the bf16 tensor cores, 0.197 ms at the f32 rate of 67
// TFLOP/s). This first kernel multiplies with f32 FMAs on the CUDA cores
// in both types, so it is bound by the f32 rate; moving the product onto
// the tensor cores (mma/wgmma on bf16 tiles) is later work.
//
// Design: one block per 128 x 64 output tile (conv_bn.cuh), K in slices
// of 16 staged in shared memory as f32. The epilogue rounds the tile to
// y's type, stores it, and sums each column of the stored values over the
// tile's rows into a per-tile partial row; a second launch sums the
// partial rows in a fixed order. No atomics: the statistics are the same
// bits on every launch, whatever the grid's scheduling.
#include "conv_bn.cuh"

namespace {

using namespace dl4j::convbn;

template <typename T>
__global__ void __launch_bounds__(NT) conv1x1_stats_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    float* __restrict__ part1, float* __restrict__ part2, int M, int K, int N) {
  __shared__ __align__(16) float As[BK * AS_LD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  Tile t;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) t.acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slice [BM, BK]: consecutive threads read consecutive k of one row
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int m = m0 + mm, k = k0 + kk;
      As[kk * AS_LD + mm] = (m < M && k < K) ? dl4j::to_f32(x[(size_t)m * K + k]) : 0.0f;
    }
    load_w_slice<T>(Bs, w, k0, n0, K, N);
    __syncthreads();
    mac_slice(t, As, Bs, tx, ty);
    __syncthreads();
  }
  store_with_stats<T>(t, y, part1, part2, As, m0, n0, M, N, tx, ty);
}

template <typename T>
int launch(const void* x, const void* w, void* y, void* s1, void* s2, void* part,
           int M, int K, int N, cudaStream_t stream) {
  const int P = (M + BM - 1) / BM;
  float* part1 = static_cast<float*>(part);
  float* part2 = part1 + (size_t)P * N;
  dim3 grid(P, (N + BN - 1) / BN);
  conv1x1_stats_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), part1,
      part2, M, K, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_column_sums(part1, part2, static_cast<float*>(s1),
                            static_cast<float*>(s2), P, N, stream);
}

}  // namespace

// Rows per output tile: the wrapper sizes the partial-sum scratch
// [2, ceil(M / rows), N] f32 from it.
extern "C" int conv1x1_stats_tile_rows() { return BM; }

// dtype: 0 = f32, 1 = bf16. Returns cudaGetLastError() after the launches.
extern "C" int conv1x1_stats(int dtype, const void* x, const void* w, void* y, void* s1,
                             void* s2, void* part, int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, y, s1, s2, part, M, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, s1, s2, part, M, K, N, s);
  return cudaErrorInvalidValue;
}
