// The batch-norm pullback's two passes over [M, C] (NHWC rows):
//   K7, reduce:  sum_g[c] = sum_m g[m, c]   sum_gx[c] = sum_m g[m, c] * x[m, c]
//   K8, apply:   dx[m, c] = c1[c] * g[m, c] - c3[c] * x[m, c] + c0[c]
// x is the tensor dx is affine in (x - bf16(mean) for bf16, raw x for
// f32); the per-channel coefficients between the passes are plain torch in
// the wrapper, as in the JAX package. Math in f32; sums in f32; dx in g's
// type.
//
// Both passes take an optional prologue, computed in registers as each
// element is loaded, so the caller materialises neither tensor:
// - gate (gate_y given): g = (y > 0) ? g : 0, the ReLU's pullback from the
//   saved BN output y, exactly torch.where(y > 0, g, 0);
// - centring (mean_b given): x = T(f32(x) - mean_b[c]), the same rounding
//   as `x - mean_b` in T, so the sums and dx see the bits the materialised
//   tensor would hold.
//
// Replaces: deeplearning4j_tpu/ops/pallas_conv_bn.py `_bnb_reduce_call` ->
// `_bnb_reduce_kernel` (K7) and `_bnb_apply_call` -> `_bnb_apply_kernel`
// (K8).
//
// What bounds it on an H100: bytes. K7 reads g and x once (2 * M * C *
// sizeof(T); 3 with the gate's y); K8 reads them again and writes dx (3 *
// M * C * sizeof(T); 4 with y). At [128*56*56, 256] in bf16 that is 411 MB
// (0.12 ms) and 617 MB (0.18 ms) at 3.35 TB/s.
//
// Design. K7: a block owns 32 channels by 8 row lanes over a fixed chunk
// of rows; warps read 32 neighbouring channels of a row. Lane sums are
// combined in lane order, each chunk writes one partial row, and a second
// launch sums the partial rows in order (conv_bn.cuh `column_sums`). The
// chunking depends on M alone, so the sums are the same bits on every
// launch, with or without the prologue. K8: bn_stream.cuh's layout, as K6
// (bn_apply.cu): c1, c3, c0 (and mean_b) in registers for a thread's fixed
// unit of channels, a block per unrolled group of streaming loads of g, x
// (and y).
// The prologue and the arithmetic after it are the same instructions with
// and without it: dx = fma(c1, g, fma(-c3, x, c0)).
#include "bn_stream.cuh"
#include "conv_bn.cuh"

namespace {

using dl4j::bnstream::round_to;

constexpr int RED_COLS = 32;
constexpr int RED_LANES = 8;

template <typename T, bool GATE, bool CENTER>
__global__ void __launch_bounds__(RED_COLS * RED_LANES) bn_reduce_kernel(
    const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ mean_b,
    const T* __restrict__ gate_y, float* __restrict__ part_g, float* __restrict__ part_gx,
    int M, int C, int rows_per_chunk) {
  __shared__ float red_g[RED_LANES][RED_COLS], red_gx[RED_LANES][RED_COLS];
  const int cl = threadIdx.x % RED_COLS, l = threadIdx.x / RED_COLS;
  const int c = blockIdx.x * RED_COLS + cl;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(r0 + rows_per_chunk, M);
  float sg = 0.0f, sgx = 0.0f;
  if (c < C) {
    const float mb = CENTER ? mean_b[c] : 0.0f;
    for (int r = r0 + l; r < r1; r += RED_LANES) {
      const size_t e = (size_t)r * C + c;
      float gv = dl4j::to_f32(g[e]);
      if constexpr (GATE) gv = dl4j::to_f32(gate_y[e]) > 0.0f ? gv : 0.0f;
      float xv = dl4j::to_f32(x[e]);
      if constexpr (CENTER) xv = round_to<T>(xv - mb);
      sg += gv;
      sgx = fmaf(gv, xv, sgx);
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

template <typename T, int V, bool GATE, bool CENTER>
__global__ void __launch_bounds__(dl4j::bnstream::THREADS) bn_dx_kernel(
    const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ mean_b,
    const T* __restrict__ gate_y, const float* __restrict__ c1, const float* __restrict__ c3,
    const float* __restrict__ c0, T* __restrict__ dx, dl4j::bnstream::Geom geo) {
  using namespace dl4j::bnstream;
  constexpr int U = UNROLL;
  const Place p = place(geo);
  if (p.u < 0) return;
  const int ch = p.u * V;
  float k1[V], k3[V], k0[V], mb[V];
  coefficients<V>(c1, ch, k1);
  coefficients<V>(c3, ch, k3);
  coefficients<V>(c0, ch, k0);
  if constexpr (CENTER) coefficients<V>(mean_b, ch, mb);
  for (long long r0 = p.row; r0 < geo.M; r0 += sweep(geo)) {
    Unit<T, V> gi[U], xi[U], yi[GATE ? U : 1];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long r = r0 + (long long)k * geo.rows;
      if (r < geo.M) {
        const long long e = r * geo.C + ch;
        gi[k].load(g + e);
        xi[k].load(x + e);
        if constexpr (GATE) yi[k].load(gate_y + e);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long r = r0 + (long long)k * geo.rows;
      if (r < geo.M) {
        float gv[V], xv[V], yv[V];
        gi[k].get(gv);
        xi[k].get(xv);
        if constexpr (GATE) yi[k].get(yv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if constexpr (GATE) gv[i] = yv[i] > 0.0f ? gv[i] : 0.0f;
          if constexpr (CENTER) xv[i] = round_to<T>(xv[i] - mb[i]);
          gv[i] = fmaf(k1[i], gv[i], fmaf(-k3[i], xv[i], k0[i]));
        }
        Unit<T, V> out;
        out.set(gv);
        out.store(dx + r * geo.C + ch);
      }
    }
  }
}

template <typename T, bool GATE, bool CENTER>
int launch_reduce(const void* g, const void* x, const void* mb, const void* gy, float* pg,
                  float* pgx, int M, int C, int chunks, cudaStream_t stream) {
  const int rows = (M + chunks - 1) / chunks;
  dim3 grid((C + RED_COLS - 1) / RED_COLS, chunks);
  bn_reduce_kernel<T, GATE, CENTER><<<grid, RED_COLS * RED_LANES, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const float*>(mb),
      static_cast<const T*>(gy), pg, pgx, M, C, rows);
  return cudaGetLastError();
}

template <typename T>
int launch_reduce(const void* g, const void* x, const void* mb, const void* gy, void* sum_g,
                  void* sum_gx, void* part, int M, int C, int chunks, cudaStream_t stream) {
  float* pg = static_cast<float*>(part);
  float* pgx = pg + (size_t)chunks * C;
  int e;
  if (gy && mb)
    e = launch_reduce<T, true, true>(g, x, mb, gy, pg, pgx, M, C, chunks, stream);
  else if (gy)
    e = launch_reduce<T, true, false>(g, x, mb, gy, pg, pgx, M, C, chunks, stream);
  else if (mb)
    e = launch_reduce<T, false, true>(g, x, mb, gy, pg, pgx, M, C, chunks, stream);
  else
    e = launch_reduce<T, false, false>(g, x, mb, gy, pg, pgx, M, C, chunks, stream);
  if (e != cudaSuccess) return e;
  return dl4j::convbn::launch_column_sums(pg, pgx, static_cast<float*>(sum_g),
                                          static_cast<float*>(sum_gx), chunks, C, stream);
}

template <typename T, int V, bool GATE, bool CENTER>
int launch_dx(const void* g, const void* x, const void* mb, const void* gy, const void* c1,
              const void* c3, const void* c0, void* dx, int M, int C, cudaStream_t stream) {
  using namespace dl4j::bnstream;
  const Geom geo = geometry(M, C, V);
  bn_dx_kernel<T, V, GATE, CENTER><<<grid<bn_dx_kernel<T, V, GATE, CENTER>>(geo),
                                     geo.rows * geo.cols, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const float*>(mb),
      static_cast<const T*>(gy), static_cast<const float*>(c1), static_cast<const float*>(c3),
      static_cast<const float*>(c0), static_cast<T*>(dx), geo);
  return cudaGetLastError();
}

template <typename T, int V>
int launch_dx(const void* g, const void* x, const void* mb, const void* gy, const void* c1,
              const void* c3, const void* c0, void* dx, int M, int C, cudaStream_t stream) {
  if (gy && mb) return launch_dx<T, V, true, true>(g, x, mb, gy, c1, c3, c0, dx, M, C, stream);
  if (gy) return launch_dx<T, V, true, false>(g, x, mb, gy, c1, c3, c0, dx, M, C, stream);
  if (mb) return launch_dx<T, V, false, true>(g, x, mb, gy, c1, c3, c0, dx, M, C, stream);
  return launch_dx<T, V, false, false>(g, x, mb, gy, c1, c3, c0, dx, M, C, stream);
}

template <typename T>
int launch_dx(const void* g, const void* x, const void* mb, const void* gy, const void* c1,
              const void* c3, const void* c0, void* dx, int M, int C, int vec,
              cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec) return launch_dx<T, V>(g, x, mb, gy, c1, c3, c0, dx, M, C, stream);
  return launch_dx<T, 1>(g, x, mb, gy, c1, c3, c0, dx, M, C, stream);
}

}  // namespace

// K7. g, x [M, C]; mean_b [C] f32 or NULL (no centring); gate_y [M, C] or
// NULL (no gate); sum_g, sum_gx [C] f32; part: f32 scratch [2, chunks, C].
// dtype: 0 = f32, 1 = bf16. Returns cudaGetLastError() after the launches.
extern "C" int bn_backward_reduce(int dtype, const void* g, const void* x, const void* mean_b,
                                  const void* gate_y, void* sum_g, void* sum_gx, void* part,
                                  int M, int C, int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 0 || C < 1 || chunks < 1) return cudaErrorInvalidValue;  // M = 0: zero sums
  if (dtype == 0)
    return launch_reduce<float>(g, x, mean_b, gate_y, sum_g, sum_gx, part, M, C, chunks, s);
  if (dtype == 1)
    return launch_reduce<__nv_bfloat16>(g, x, mean_b, gate_y, sum_g, sum_gx, part, M, C,
                                        chunks, s);
  return cudaErrorInvalidValue;
}

// K8. g, x, dx [M, C]; mean_b [C] f32 or NULL; gate_y [M, C] or NULL; c1,
// c3, c0 [C] f32. vec = 1 takes the 16-byte units (the wrapper checks C %
// (16 / sizeof(T)) == 0 and 16-byte alignment of g, x, gate_y and dx).
// dtype: 0 = f32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int bn_backward_apply(int dtype, const void* g, const void* x, const void* mean_b,
                                 const void* gate_y, const void* c1, const void* c3,
                                 const void* c0, void* dx, int M, int C, int vec,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || C < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_dx<float>(g, x, mean_b, gate_y, c1, c3, c0, dx, M, C, vec, s);
  if (dtype == 1)
    return launch_dx<__nv_bfloat16>(g, x, mean_b, gate_y, c1, c3, c0, dx, M, C, vec, s);
  return cudaErrorInvalidValue;
}
