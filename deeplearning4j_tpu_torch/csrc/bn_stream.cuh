// The streaming layout of the elementwise batch-norm passes over [M, C]
// rows (NHWC): K6 (bn_apply.cu) and K8 (bn_backward.cu).
//
// What bounds both on an H100: bytes; every element is read and written
// once at a few FLOP. What held the first (grid-stride) design at 40-60% of
// that bound was the load/store unit, not HBM: every thread recomputed its
// channel per 16-byte vector and issued 24 scalar loads of per-channel
// coefficients for it, 8 sectors a warp instruction.
//
// The layout here: a thread owns one fixed unit of V channels. V = 16 /
// sizeof(T) (one 16-byte vector: 8 bf16 or 4 f32 channels) where C % V ==
// 0 and every streamed pointer is 16-byte aligned, else V = 1 (the ragged
// case, one channel a thread). A block is rows x cols threads: cols =
// min(C / V, 256) neighbouring units of a row (column tile blockIdx.y, so
// a row of C > 2048 bf16 spans tiles) and rows = 256 / cols rows, so a
// warp's loads are one contiguous run of memory. A block takes one group
// of UNROLL row-passes (rows * UNROLL rows). Each thread loads its unit's
// per-channel coefficients once, into registers (V loads per array for
// UNROLL rows, where the first design made them for every row), then
// issues all the group's loads before any math, so UNROLL loads per
// tensor are in flight per thread. Loads and stores carry the streaming
// cache hint (ld.global.cs / st.global.cs: evict first), since no pass
// reads its data again.
//
// BN_UNROLL and BN_GRID are compile-time knobs for a sweep
// (chip_smoke.py phase 2 builds the other values into separate
// libraries); the shipped kernels use their defaults. BN_GRID 0 makes the
// grid persistent instead: as many blocks as are resident at once (by the
// occupancy calculator), each walking every gridDim.x-th group and
// loading its coefficients once for all of them. On an H100 it was 3-4%
// slower than a block per group at [401408, 256] bf16 (chip_smoke.py's
// sweep; PERF.md), where 12,544 groups make 23.8 rounds of the 528
// resident blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

#ifndef BN_UNROLL
#define BN_UNROLL 4
#endif
// 1: one block per row group; 0: a persistent grid of resident blocks
#ifndef BN_GRID
#define BN_GRID 1
#endif

namespace dl4j {
namespace bnstream {

constexpr int THREADS = 256;
constexpr int UNROLL = BN_UNROLL;

// V elements of T as the registers of one streaming load.
template <typename T, int V>
struct Unit;

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));  // round to nearest even
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return (unsigned)bf16_bits(lo) | ((unsigned)bf16_bits(hi) << 16);
}

template <>
struct Unit<float, 4> {
  uint4 w;
  __device__ __forceinline__ void load(const float* p) {
    w = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void store(float* p) const {
    __stcs(reinterpret_cast<uint4*>(p), w);
  }
  __device__ __forceinline__ void get(float* v) const {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
  __device__ __forceinline__ void set(const float* v) {
    w = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                   __float_as_uint(v[3]));
  }
};

template <>
struct Unit<__nv_bfloat16, 8> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    __stcs(reinterpret_cast<uint4*>(p), w);
  }
  __device__ __forceinline__ void get(float* v) const {
    v[0] = bf16_lo(w.x);
    v[1] = bf16_hi(w.x);
    v[2] = bf16_lo(w.y);
    v[3] = bf16_hi(w.y);
    v[4] = bf16_lo(w.z);
    v[5] = bf16_hi(w.z);
    v[6] = bf16_lo(w.w);
    v[7] = bf16_hi(w.w);
  }
  __device__ __forceinline__ void set(const float* v) {
    w = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]),
                   bf16_pair(v[6], v[7]));
  }
};

template <>
struct Unit<float, 1> {
  float w;
  __device__ __forceinline__ void load(const float* p) { w = __ldcs(p); }
  __device__ __forceinline__ void store(float* p) const { __stcs(p, w); }
  __device__ __forceinline__ void get(float* v) const { v[0] = w; }
  __device__ __forceinline__ void set(const float* v) { w = v[0]; }
};

template <>
struct Unit<__nv_bfloat16, 1> {
  unsigned short w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    __stcs(reinterpret_cast<unsigned short*>(p), w);
  }
  __device__ __forceinline__ void get(float* v) const { v[0] = __uint_as_float((unsigned)w << 16); }
  __device__ __forceinline__ void set(const float* v) { w = bf16_bits(v[0]); }
};

// v rounded to T and back: the value a tensor of T would hold.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The launch's layout; units = C / V per row, in column tiles of cols.
struct Geom {
  int M, C, units, cols, rows;
};

// This thread's place: its unit u (-1 past the row) and first row.
struct Place {
  int u;
  long long row;
};

__device__ __forceinline__ Place place(const Geom& g) {
  const int u = blockIdx.y * g.cols + (int)threadIdx.x % g.cols;
  return {u < g.units ? u : -1,
          (long long)blockIdx.x * g.rows * UNROLL + (int)threadIdx.x / g.cols};
}

// Rows between a thread's groups: the whole grid's rows per group.
__device__ __forceinline__ long long sweep(const Geom& g) {
  return (long long)gridDim.x * g.rows * UNROLL;
}

// The V per-channel f32 coefficients of channels c0.., read once a launch.
template <int V>
__device__ __forceinline__ void coefficients(const float* __restrict__ p, int c0, float* out) {
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = __ldg(p + c0 + i);
}

inline Geom geometry(int M, int C, int V) {
  Geom g;
  g.M = M;
  g.C = C;
  g.units = C / V;
  g.cols = g.units < THREADS ? g.units : THREADS;
  g.rows = THREADS / g.cols;
  return g;
}

// Blocks of the grid: (row blocks, column tiles). BN_GRID 1 launches one
// block per row group; 0 fills every SM with as many blocks as are
// resident at once (never more than there are row groups).
template <auto Kernel>
dim3 grid(const Geom& g) {
  const int tiles = (g.units + g.cols - 1) / g.cols;
  const long long per_group = (long long)g.rows * UNROLL;
  const long long groups = (g.M + per_group - 1) / per_group;
  long long blocks = groups;
  if (BN_GRID == 0) {
    // the SM count of the current device and this kernel's occupancy at
    // this block size, each asked once per process
    static int sms[64], per_sm[THREADS + 1];
    int dev = 0;
    cudaGetDevice(&dev);
    int& n_sm = sms[dev & 63];
    if (n_sm == 0) cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    int& occ = per_sm[g.rows * g.cols];
    if (occ == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, Kernel, g.rows * g.cols, 0);
    const long long resident = (long long)(n_sm > 0 ? n_sm : 1) * (occ > 0 ? occ : 1) / tiles;
    if (resident < blocks) blocks = resident;
  }
  if (blocks < 1) blocks = 1;
  return dim3((unsigned)blocks, (unsigned)tiles);
}

}  // namespace bnstream
}  // namespace dl4j
