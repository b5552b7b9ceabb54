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
// What bounds it on an H100: the product. The 3x3 64 -> 64 conv on 56x56
// at batch 128 moves about 103 MB in bf16 (0.031 ms at 3.35 TB/s) and
// does 29.6 GFLOP (0.030 ms on the bf16 tensor cores, 0.44 ms at the f32
// rate of 67 TFLOP/s), so on the tensor cores the bytes would bound it, by
// a hair. Like K4 this first kernel uses f32 FMAs on the CUDA cores, so
// the f32 rate bounds it; tensor-core tiles are later work.
//
// Design: an implicit product. Output pixels are the rows (M = N*Ho*Wo),
// the taps times input channels the depth (K = kh*kw*Cin, in HWIO order,
// so w is already the [K, Cout] operand), and the operand tile of x is
// gathered straight from the image with the halo clipped: a tap outside
// the image loads 0, so no padded copy of x exists anywhere. Each block
// decodes its 128 rows' (image, top-left corner) once into shared memory.
// The stem's Cin = 3 (K = 147) needs nothing special: depth slices are
// masked at K. The product engine and the statistics epilogue are K4's
// (conv_bn.cuh), with the same fixed-order two-stage column sums.
#include "conv_bn.cuh"

namespace {

using namespace dl4j::convbn;

struct Geom {
  int H, W, Cin, Ho, Wo, kh, kw, sh, sw, ph, pw;
};

template <typename T>
__global__ void __launch_bounds__(NT) conv_kxk_stats_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
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
          v = dl4j::to_f32(x[row_base[mm] + ((long long)ih * g.W + iw) * g.Cin + ci]);
      }
      As[kk * AS_LD + mm] = v;
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
           const Geom& g, int Nimg, int Cout, cudaStream_t stream) {
  const int M = Nimg * g.Ho * g.Wo;
  const int K = g.kh * g.kw * g.Cin;
  const int P = (M + BM - 1) / BM;
  float* part1 = static_cast<float*>(part);
  float* part2 = part1 + (size_t)P * Cout;
  dim3 grid(P, (Cout + BN - 1) / BN);
  conv_kxk_stats_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), part1,
      part2, g, M, K, Cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_column_sums(part1, part2, static_cast<float*>(s1),
                            static_cast<float*>(s2), P, Cout, stream);
}

}  // namespace

// Rows per output tile: the wrapper sizes the partial-sum scratch
// [2, ceil(N*Ho*Wo / rows), Cout] f32 from it.
extern "C" int conv_kxk_stats_tile_rows() { return BM; }

// x [Nimg, H, W, Cin], w [kh, kw, Cin, Cout], y [Nimg, Ho, Wo, Cout];
// (ph, pw) are the low-side SAME pads. dtype: 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the launches.
extern "C" int conv_kxk_stats(int dtype, const void* x, const void* w, void* y, void* s1,
                              void* s2, void* part, int Nimg, int H, int W, int Cin,
                              int kh, int kw, int Cout, int Ho, int Wo, int sh, int sw,
                              int ph, int pw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{H, W, Cin, Ho, Wo, kh, kw, sh, sw, ph, pw};
  if (dtype == 0) return launch<float>(x, w, y, s1, s2, part, g, Nimg, Cout, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, s1, s2, part, g, Nimg, Cout, s);
  return cudaErrorInvalidValue;
}
