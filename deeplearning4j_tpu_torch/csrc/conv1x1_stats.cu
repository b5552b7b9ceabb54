// A 1x1 convolution as a product, with the batch-norm statistics epilogue:
//   y = x @ w              x [M, Cin] (NHWC rows), w [Cin, Cout] (HWIO 1x1)
//   s1[c] = sum_m y[m, c]  s2[c] = sum_m y[m, c]^2
// with the sums taken over y as stored (rounded to y's type), in f32.
// A stride-2 1x1 conv arrives here as the caller's x[:, ::2, ::2, :].
//
// Replaces: deeplearning4j_tpu/ops/pallas_conv_bn.py `_mm_stats_call` ->
// `_mm_stats_kernel` (K4).
//
// What bounds it on an H100: bytes, once the product is on the tensor
// cores. At ResNet-50's largest 1x1 instance at batch 128 (64 -> 256 on
// 56x56, M = 401,408) the function moves about 257 MB in bf16 (0.077 ms at
// 3.35 TB/s), 205 MB of it the store of y, and does 13.2 GFLOP (0.013 ms
// on the bf16 tensor cores).
//
// Design (bf16): the one-tap, dense-row case of the tensor-core engine in
// conv_bn.cuh. Rows of x are contiguous, so the producer copies them with
// 16-byte cp.async straight into the swizzled A slice; the two warpgroups
// multiply with wgmma; the epilogue rounds the tile to bf16, sums each
// column of the rounded values in a fixed order, and stores y with 16-byte
// coalesced stores through the ring, since at this shape the store decides
// the time. At Cin = 64 the depth is one slice, so nothing overlaps within
// a block: the ring is sized min(stages, K / 64) by the caller and stays
// small enough for two resident blocks per SM, which hide each other's
// latency. A second launch sums the per-tile partial rows in a fixed order:
// no atomics, the statistics are the same bits on every launch.
// f32 keeps the first engine (f32 FMAs on the CUDA cores; conv_bn.cuh).
#include "conv_bn.cuh"

namespace {

using namespace dl4j::convbn;
using namespace dl4j::convbn::simt;

__global__ void __launch_bounds__(NT) conv1x1_stats_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
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
      As[kk * AS_LD + mm] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.0f;
    }
    load_w_slice<float>(Bs, w, k0, n0, K, N);
    __syncthreads();
    mac_slice(t, As, Bs, tx, ty);
    __syncthreads();
  }
  store_with_stats<float>(t, y, part1, part2, As, m0, n0, M, N, tx, ty);
}

template <int BN, bool GATHER>
__global__ void __launch_bounds__(tc::NT, 2) conv1x1_stats_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ y, float* __restrict__ part1, float* __restrict__ part2, Geom g,
    int M, int K, int N, int stages) {
  tc::conv_tile<BN, GATHER, true>(x, w, y, part1, part2, g, M, K, N, stages);
}

struct Bf16Kernels {
  template <int BN, bool GATHER>
  static tc::KernelFn kernel() {
    return conv1x1_stats_bf16_kernel<BN, GATHER>;
  }
};

}  // namespace

// dtype: 0 = f32, 1 = bf16. variant: 0 = the f32 FMA engine, 1 = the
// tensor-core engine with the cp.async producer, 2 = with the gather
// producer; bn (64 or 128) and stages (ring slices) apply to 1 and 2.
// tile_rows must be the engines' rows per tile (128): the caller sized the
// partial-sum scratch part [2, ceil(M / tile_rows), N] f32 from it.
// Returns cudaGetLastError() after the launches.
extern "C" int conv1x1_stats(int dtype, const void* x, const void* w, void* y, void* s1,
                             void* s2, void* part, int M, int K, int N, int variant, int bn,
                             int stages, int tile_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{1, 1, K, 1, 1, 1, 1, 1, 1, 0, 0};  // one pixel per row of x
  auto simt_launch = [&](float* part1, float* part2) {
    dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    conv1x1_stats_f32_kernel<<<grid, NT, 0, s>>>(static_cast<const float*>(x),
                                                  static_cast<const float*>(w),
                                                  static_cast<float*>(y), part1, part2, M, K, N);
    return cudaGetLastError();
  };
  return launch_conv_stats<Bf16Kernels>(dtype, variant, bn, stages, tile_rows, simt_launch, x,
                                        w, y, s1, s2, part, g, M, K, N, s);
}
