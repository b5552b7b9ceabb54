// Shared pieces of the conv/BN kernels (K4-K8): the tiled f32 product
// engine with its BN-statistics epilogue, used by conv1x1_stats.cu and
// conv_kxk_stats.cu; the fixed-order column sum that combines per-block
// partial sums (the second stage of every statistics reduction here); and
// vector loads for the streaming passes of bn_apply.cu and bn_backward.cu.
//
// Determinism: every reduction is a fixed tree over a grid that depends
// only on the shapes. No float atomics: the statistics of one input are
// bit-identical from launch to launch and do not depend on the card.
#pragma once

#include "common.cuh"

namespace dl4j {
namespace convbn {

// -- the product tile -------------------------------------------------------
//
// A block computes a BM x BN tile of y = A @ W ([M, K] x [K, N]) with NT
// threads in a 16 x 16 grid, each owning TM x TN outputs (rows ty*TM..,
// columns tx*TN..), with f32 FMAs over BK-deep slices staged in shared
// memory as f32 (A transposed, so a thread's TM rows are one float4 pair).
constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int TN = 4;
constexpr int NT = 256;
constexpr int AS_LD = BM + 4;  // padded row of the transposed A slice

struct Tile {
  float acc[TM][TN];
};

// W slice [BK, BN] from row-major W [K, N] into Bs (zero outside).
template <typename T>
__device__ __forceinline__ void load_w_slice(float (*Bs)[BN], const T* __restrict__ w,
                                             int k0, int n0, int K, int N) {
  for (int i = threadIdx.x; i < BK * BN; i += NT) {
    const int kk = i / BN, nn = i % BN;
    const int k = k0 + kk, n = n0 + nn;
    Bs[kk][nn] = (k < K && n < N) ? to_f32(w[(size_t)k * N + n]) : 0.0f;
  }
}

// acc += As^T[rows] * Bs[:, cols] over one BK slice.
__device__ __forceinline__ void mac_slice(Tile& t, const float* __restrict__ As,
                                          float (*Bs)[BN], int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * AS_LD + ty * TM);
    const float4 a1 = *reinterpret_cast<const float4*>(As + kk * AS_LD + ty * TM + 4);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
    const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) t.acc[i][j] = fmaf(a[i], bv[j], t.acc[i][j]);
  }
}

// The epilogue: round each output to T, store it, and add the STORED value
// (what the normalize will read) to per-column sums of y and y^2 over the
// tile's valid rows. The 16 row-groups' partials are combined in order
// 0..15 through shared memory `red` (2 * 16 * BN floats, may alias As),
// and the tile's column sums go to row blockIdx.x of part1/part2 [P, N].
template <typename T>
__device__ __forceinline__ void store_with_stats(const Tile& t, T* __restrict__ y,
                                                 float* __restrict__ part1,
                                                 float* __restrict__ part2, float* red,
                                                 int m0, int n0, int M, int N, int tx,
                                                 int ty) {
  float c1[TN], c2[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) c1[j] = c2[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      const T v = from_f32<T>(t.acc[i][j]);
      y[(size_t)m * N + n] = v;
      const float f = to_f32(v);
      c1[j] += f;
      c2[j] = fmaf(f, f, c2[j]);
    }
  }
  __syncthreads();  // `red` may alias the operand slices
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    red[ty * BN + tx * TN + j] = c1[j];
    red[16 * BN + ty * BN + tx * TN + j] = c2[j];
  }
  __syncthreads();
  if (threadIdx.x < BN) {
    const int c = threadIdx.x, n = n0 + c;
    float s1 = 0.0f, s2 = 0.0f;
    for (int r = 0; r < 16; ++r) {
      s1 += red[r * BN + c];
      s2 += red[16 * BN + r * BN + c];
    }
    if (n < N) {
      part1[(size_t)blockIdx.x * N + n] = s1;
      part2[(size_t)blockIdx.x * N + n] = s2;
    }
  }
}

// -- second stage of a column reduction -------------------------------------
//
// out[n] = sum over p = 0..P-1 of part[p][n], for two arrays at once
// (blockIdx.y picks which). A block is 32 columns x 8 lanes; lane l sums
// rows l, l+8, ... and the 8 lane sums are combined in order.
constexpr int CS_COLS = 32;
constexpr int CS_LANES = 8;

__global__ void __launch_bounds__(CS_COLS * CS_LANES) column_sums(
    const float* __restrict__ part_a, const float* __restrict__ part_b,
    float* __restrict__ out_a, float* __restrict__ out_b, int P, int N) {
  __shared__ float red[CS_LANES][CS_COLS];
  const float* part = blockIdx.y == 0 ? part_a : part_b;
  float* out = blockIdx.y == 0 ? out_a : out_b;
  const int c = threadIdx.x % CS_COLS, l = threadIdx.x / CS_COLS;
  const int n = blockIdx.x * CS_COLS + c;
  float s = 0.0f;
  if (n < N)
    for (int p = l; p < P; p += CS_LANES) s += part[(size_t)p * N + n];
  red[l][c] = s;
  __syncthreads();
  if (l == 0 && n < N) {
    float t = 0.0f;
    for (int i = 0; i < CS_LANES; ++i) t += red[i][c];
    out[n] = t;
  }
}

inline cudaError_t launch_column_sums(const float* part_a, const float* part_b,
                                      float* out_a, float* out_b, int P, int N,
                                      cudaStream_t stream) {
  dim3 grid((N + CS_COLS - 1) / CS_COLS, 2);
  column_sums<<<grid, CS_COLS * CS_LANES, 0, stream>>>(part_a, part_b, out_a, out_b, P, N);
  return cudaGetLastError();
}

// -- vector access for the streaming passes ---------------------------------

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* out) {
  const Vec<T, V> q = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f32(q.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_from_f32(T* __restrict__ p, const float* in) {
  Vec<T, V> q;
#pragma unroll
  for (int i = 0; i < V; ++i) q.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Vec<T, V>*>(p) = q;
}

// Blocks for a grid-stride pass over `units` work items of NT threads.
inline int stream_blocks(long long units, int threads) {
  long long b = (units + threads - 1) / threads;
  const long long cap = 132LL * 16;  // enough blocks to fill every SM
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

}  // namespace convbn
}  // namespace dl4j
