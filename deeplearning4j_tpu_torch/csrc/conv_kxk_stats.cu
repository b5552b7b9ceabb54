// A SAME k x k convolution (NHWC x HWIO, bias-free), with the batch-norm
// statistics epilogue:
//   y[n, i, j, c] = sum_{a, b, ci} x[n, i*sh + a - ph, j*sw + b - pw, ci] * w[a, b, ci, c]
//   s1[c] = sum y[..., c]   s2[c] = sum y[..., c]^2   (of y as stored, f32)
// Taps that fall outside the image read zero. The padding is XLA's SAME:
// out = ceil(in / s), pad_lo = max((out - 1) * s + k - in, 0) / 2, and the
// odd extra pixel goes on the high side (the stem 7x7/2 on 224 pads 2 and
// 3, a 3x3/2 on 56 pads 0 and 1).
//
// Replaces: deeplearning4j_tpu/ops/pallas_conv_bn.py `_ck_stats_call` ->
// `_ck_stats_kernel` (K5): 3x3/s1, 3x3/s2 and the 7x7/s2 stem.
//
// What bounds it on an H100: bytes, once the product is on the tensor
// cores. The 3x3 64 -> 64 conv on 56x56 at batch 128 moves about 103 MB in
// bf16 (0.031 ms at 3.35 TB/s) and does 29.6 GFLOP (0.030 ms on the bf16
// tensor cores): bytes by a hair. Gathered for nine taps, A crosses from
// L2 to shared memory nine times, so that traffic, not HBM, is the
// practical floor of an implicit product.
//
// Design (bf16): an implicit product on the tensor-core engine of
// conv_bn.cuh. Each block decodes its rows' (image, top-left corner) once.
// A 64-deep slice is one tap x 64 channels where Cin % 64 == 0, so the tap
// and channel offset are decoded once per slice and a row's slice is 8
// contiguous 16-byte chunks of one pixel, copied by cp.async with zero
// fill for a tap outside the image (no padded copy of x exists anywhere);
// where Cin % 8 == 0 but not % 64 a slice may straddle taps, and each
// 16-byte chunk column decodes its own. Where Cin % 8 != 0 (the stem's
// Cin = 3, K = 147 padded to 192) a scalar gather writes the same swizzled
// slices, so the stem runs on the tensor cores too. The statistics
// epilogue and the fixed-order two-stage column sums are K4's.
// f32 keeps the first engine (f32 FMAs on the CUDA cores; conv_bn.cuh).
#include "conv_bn.cuh"

namespace {

using namespace dl4j::convbn;
using namespace dl4j::convbn::simt;

__global__ void __launch_bounds__(NT) conv_kxk_stats_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
    float* __restrict__ part1, float* __restrict__ part2, Geom g, int M, int K, int N) {
  __shared__ __align__(16) float As[BK * AS_LD];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ long long row_base[BM];  // offset of the row's image in x
  __shared__ int row_ih[BM], row_iw[BM];  // top-left tap, before the taps' offsets
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  for (int mm = threadIdx.x; mm < BM; mm += NT) {
    const int m = m0 + mm;
    if (m < M) {
      const int ow = m % g.Wo, r = m / g.Wo;
      const int oh = r % g.Ho, n = r / g.Ho;
      row_base[mm] = (long long)n * g.H * g.W * g.Cin;
      row_ih[mm] = oh * g.sh - g.ph;
      row_iw[mm] = ow * g.sw - g.pw;
    } else {
      row_base[mm] = 0;
      row_ih[mm] = -(1 << 28);  // every tap misses the image
      row_iw[mm] = 0;
    }
  }
  Tile t;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) t.acc[i][j] = 0.0f;
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int k = k0 + kk;
      float v = 0.0f;
      if (k < K) {
        const int ci = k % g.Cin, tap = k / g.Cin;
        const int ih = row_ih[mm] + tap / g.kw, iw = row_iw[mm] + tap % g.kw;
        if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
          v = x[row_base[mm] + ((long long)ih * g.W + iw) * g.Cin + ci];
      }
      As[kk * AS_LD + mm] = v;
    }
    load_w_slice<float>(Bs, w, k0, n0, K, N);
    __syncthreads();
    mac_slice(t, As, Bs, tx, ty);
    __syncthreads();
  }
  store_with_stats<float>(t, y, part1, part2, As, m0, n0, M, N, tx, ty);
}

template <int BN, bool GATHER>
__global__ void __launch_bounds__(tc::NT, 2) conv_kxk_stats_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ y, float* __restrict__ part1, float* __restrict__ part2, Geom g,
    int M, int K, int N, int stages) {
  tc::conv_tile<BN, GATHER, false>(x, w, y, part1, part2, g, M, K, N, stages);
}

struct Bf16Kernels {
  template <int BN, bool GATHER>
  static tc::KernelFn kernel() {
    return conv_kxk_stats_bf16_kernel<BN, GATHER>;
  }
};

}  // namespace

// x [Nimg, H, W, Cin], w [kh, kw, Cin, Cout], y [Nimg, Ho, Wo, Cout];
// (ph, pw) are the low-side SAME pads. dtype: 0 = f32, 1 = bf16. variant,
// bn, stages and tile_rows as for conv1x1_stats (conv1x1_stats.cu); the
// partial-sum scratch is [2, ceil(Nimg*Ho*Wo / tile_rows), Cout] f32.
// Returns cudaGetLastError() after the launches.
extern "C" int conv_kxk_stats(int dtype, const void* x, const void* w, void* y, void* s1,
                              void* s2, void* part, int Nimg, int H, int W, int Cin,
                              int kh, int kw, int Cout, int Ho, int Wo, int sh, int sw,
                              int ph, int pw, int variant, int bn, int stages, int tile_rows,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{H, W, Cin, Ho, Wo, kh, kw, sh, sw, ph, pw};
  const int M = Nimg * Ho * Wo, K = kh * kw * Cin;
  auto simt_launch = [&](float* part1, float* part2) {
    dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
    conv_kxk_stats_f32_kernel<<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
        part1, part2, g, M, K, Cout);
    return cudaGetLastError();
  };
  return launch_conv_stats<Bf16Kernels>(dtype, variant, bn, stages, tile_rows, simt_launch, x,
                                        w, y, s1, s2, part, g, M, K, Cout, s);
}
