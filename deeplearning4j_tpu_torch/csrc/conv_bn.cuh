// Shared pieces of the conv/BN kernels (K4, K5, K7): the two product engines of
// K4 and K5 with their BN-statistics epilogues, used by conv1x1_stats.cu
// and conv_kxk_stats.cu; the fixed-order column sum that combines per-tile
// partial sums (the second stage of every statistics reduction here, K7's
// too).
//
// With conv1x1_stats.cu and conv_kxk_stats.cu this replaces
// deeplearning4j_tpu/ops/pallas_conv_bn.py `_mm_stats_call` ->
// `_mm_stats_kernel` (K4) and `_ck_stats_call` -> `_ck_stats_kernel` (K5).
// What bounds them on an H100, once the product is on the tensor cores:
// bytes, 0.077 ms for K4's 1x1 64 -> 256 and 0.031 ms for K5's 3x3 64 -> 64
// on 56x56 at batch 128 (3.35 TB/s). The design answers with bf16 wgmma
// tiles fed by an asynchronous ring (below), so loads overlap the product,
// and 16-byte stores of y, the largest stream at K4's shapes.
//
// Both convolutions are one implicit product y = A @ W: output pixels are
// the rows (M = N*Ho*Wo), taps times input channels the depth (K =
// kh*kw*Cin, HWIO order, so w is already the [K, Cout] operand), and A is
// gathered from the NHWC image with every tap clipped at the edge (no
// padded copy of x). K4's 1x1 product is the case H = W = Ho = Wo = kh =
// kw = 1, Cin = K: a row of A is a row of x2.
//
// - bf16 (the training dtype): `tc`, a 128 x BN tile on the tensor cores.
//   Two consumer warpgroups of 64 rows each run
//   wgmma.m64n{BN}k16.f32.bf16.bf16 from a ring of 64-deep operand slices
//   in dynamic shared memory (128-byte swizzle, the layout the wgmma
//   descriptors name). Every thread also produces: cp.async 16-byte copies
//   with zero fill where Cin and Cout are multiples of 8 and the pointers
//   16-byte aligned ("vector"), else a scalar gather written into the same
//   swizzled layout ("gather", e.g. the stem's Cin = 3), so both feed the
//   same wgmma consumers. The ring holds `stages` slices: while the
//   warpgroups multiply one, the others are in flight. The epilogue stages
//   the rounded tile through the ring and stores it with 16-byte coalesced
//   stores.
// - f32: `simt`, the first engine: a 128 x 64 tile of f32 FMAs on the CUDA
//   cores. It stays for f32, which is what the f32 holds against the plain
//   versions run with TF32 off: TF32 tensor cores keep ~3 decimal digits
//   and would break their 1e-5 tolerances.
//
// Determinism: every reduction is a fixed tree over a grid that depends
// only on the shapes. No float atomics: the statistics of one input are
// bit-identical from launch to launch and do not depend on the card.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace dl4j {
namespace convbn {

// A SAME conv as an implicit product; (ph, pw) are the low-side pads.
struct Geom {
  int H, W, Cin, Ho, Wo, kh, kw, sh, sw, ph, pw;
};

constexpr int TILE_M = 128;  // rows per output tile, in both engines

// -- the f32 FMA engine -------------------------------------------------------
//
// A block computes a BM x BN tile of y = A @ W ([M, K] x [K, N]) with NT
// threads in a 16 x 16 grid, each owning TM x TN outputs (rows ty*TM..,
// columns tx*TN..), with f32 FMAs over BK-deep slices staged in shared
// memory as f32 (A transposed, so a thread's TM rows are one float4 pair).
namespace simt {

constexpr int BM = TILE_M;
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

}  // namespace simt

// -- the bf16 tensor-core engine ---------------------------------------------
//
// One block per 128 x BN output tile (BN = 128, or 64 where Cout <= 64),
// 256 threads = two warpgroups. Depth comes in slices of BK = 64 bf16: one
// 128-byte swizzle row, and for every ResNet-50 3x3 conv exactly one tap x
// 64 channels. A stage of the ring is A [128, 64] (K-major: row r's 64
// values in one 128-byte row, 16-byte chunk c at chunk c ^ (r % 8)) then
// B [64, BN] (N-major, as w is stored: 64-column panels of 64 rows x 128
// bytes, chunk c of row k at c ^ (k % 8)); B is read with wgmma's
// transpose flag, which 16-bit types allow. Every stage is 1024-byte
// aligned, so the swizzle phase is the row's.
//
// The pipeline, for slices kt = 0 .. KT-1 with a ring of S stages:
//   prologue: slices 0 .. S-1 into stages 0 .. S-1 (one cp.async group each)
//   loop:     cp.async.wait_group S-1   (this thread's copies of slice kt)
//             fence.proxy.async, __syncthreads, fence.proxy.async
//                                        (everyone's copies, seen by wgmma)
//             4 x wgmma k16 on stage kt % S, commit
//             [gather: load slice kt+S into registers meanwhile]
//             wgmma.wait_group 0, __syncthreads (both warpgroups are done
//                                        with the stage)
//             refill stage kt % S with slice kt+S, commit (empty at the end)
// so a stage is refilled only after every consumer retired its wgmmas on
// it, and S-1 slices stay in flight while the tensor cores work.
namespace tc {

constexpr int BM = TILE_M;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int A_STAGE = BM * BK * 2;  // 16 KB
constexpr int MAX_STAGES = 4;

template <int BN>
struct Cfg {
  static constexpr int CH = BN / 8;             // 16-byte chunks in a B row / y row
  static constexpr int STAGE = A_STAGE + BK * BN * 2;
  static constexpr int B_ROWS = NT / CH;        // B rows one pass of the block fills
  static constexpr int B_PASSES = BK / B_ROWS;  // B chunks per thread per slice
  static constexpr int ACC = BN / 2;            // f32 accumulators per thread
};

// Dynamic shared memory of a launch: the ring, plus slack to align it.
__host__ __device__ constexpr int ring_bytes(int bn, int stages) {
  return stages * (A_STAGE + BK * bn * 2) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of 128-byte row r under the 128B swizzle.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// Chunk c (8 columns) of B row k: 64-column panels of BK rows x 128 bytes.
__device__ __forceinline__ uint32_t b_off(int k, int c) {
  return static_cast<uint32_t>((c >> 3) * (BK * 128)) + sw128(k, c & 7);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start, leading and
// stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 16 bytes global -> shared, asynchronously; zero fill when !full.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` (0..3, uniform) of this thread's groups are
// in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
// Generic-proxy writes to shared memory become visible to the async proxy
// (wgmma's operand reads). Without it wgmma may read stale data: wrong
// numbers, no error.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator accesses across the async
// wgmma boundaries.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A[64 x 16] (K-major) @ B[16 x BN] (N-major), both from shared memory.
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// The kernels' signature; each .cu wraps conv_tile in a __global__ of its
// own name (so a profile tells K4 from K5) and hands launch() a `Kernels`
// type whose kernel<BN, GATHER>() returns it.
using KernelFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*, float*,
                          float*, Geom, int, int, int, int);

// One 128 x BN tile of y and its column sums. DENSE: K4's case (a row of A
// is row m of x, no tap decode).
template <int BN, bool GATHER, bool DENSE>
__device__ __forceinline__ void conv_tile(const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ w,
                                          __nv_bfloat16* __restrict__ y,
                                          float* __restrict__ part1, float* __restrict__ part2,
                                          const Geom& g, int M, int K, int N, int stages) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ float red[2][8][BN];  // per-warp column sums of y and y^2
  uint8_t* ring = dyn_smem + ((1024 - (smem_u32(dyn_smem) & 1023)) & 1023);
  const uint32_t ring_u = smem_u32(ring);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(w);

  const int tid = threadIdx.x;
  const int tiles_n = (N + BN - 1) / BN;  // N tiles vary fastest: they share A
  const int mt = blockIdx.x / tiles_n;
  const int m0 = mt * BM, n0 = (blockIdx.x - mt * tiles_n) * BN;
  const int KT = (K + BK - 1) / BK;

  // A producer: chunk column ac (k = 8*ac ..) of rows tid/8 + 32j, each
  // row decoded once: its image's offset in x and its top-left tap.
  const int ac = tid & 7;
  int rbase[4], rih[4], riw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + (tid >> 3) + 32 * j;
    if (DENSE) {
      rbase[j] = m < M ? m * g.Cin : 0;
      rih[j] = m < M ? 0 : -(1 << 28);
      riw[j] = 0;
    } else if (m < M) {
      const int ow = m % g.Wo, t = m / g.Wo;
      const int oh = t % g.Ho, n = t / g.Ho;
      rbase[j] = n * g.H * g.W * g.Cin;
      rih[j] = oh * g.sh - g.ph;
      riw[j] = ow * g.sw - g.pw;
    } else {
      rbase[j] = 0;
      rih[j] = -(1 << 28);  // every tap misses the image
      riw[j] = 0;
    }
  }
  // B producer: chunk column bc of B rows tid/CH + B_ROWS*j.
  const int bc = tid % C::CH, br = tid / C::CH;
  const int bn = n0 + 8 * bc;

  // (tap row, tap column, channel) of depth index k.
  auto decode = [&](int k, int& dh, int& dw, int& ci) {
    if (DENSE) {
      dh = dw = 0;
      ci = k;
      return;
    }
    const int tap = k / g.Cin;
    ci = k - tap * g.Cin;
    dh = tap / g.kw;
    dw = tap - dh * g.kw;
  };

  // vector producer: slice -> stage by cp.async, tap and channel decoded
  // once per 16-byte chunk column (a chunk never straddles taps: Cin % 8 == 0)
  auto copy_vector = [&](int slice, int stage) {
    const uint32_t sa = ring_u + stage * C::STAGE;
    const int k = slice * BK + 8 * ac;
    int dh, dw, ci;
    decode(k, dh, dw, ci);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ih = rih[j] + dh, iw = riw[j] + dw;
      const bool ok = k < K && (unsigned)ih < (unsigned)g.H && (unsigned)iw < (unsigned)g.W;
      const __nv_bfloat16* src = ok ? x + rbase[j] + (ih * g.W + iw) * g.Cin + ci : x;
      cp_async16(sa + sw128((tid >> 3) + 32 * j, ac), src, ok);
    }
#pragma unroll
    for (int j = 0; j < C::B_PASSES; ++j) {
      const int kr = br + C::B_ROWS * j, kk = slice * BK + kr;
      const bool ok = kk < K && bn < N;
      cp_async16(sa + A_STAGE + b_off(kr, bc), ok ? w + (size_t)kk * N + bn : w, ok);
    }
  };

  // gather producer: 8 scalar loads per chunk, packed to 16 bytes
  uint4 ga[4], gb[C::B_PASSES];
  auto gather_load = [&](int slice) {
    const int k0 = slice * BK + 8 * ac;
    int dh, dw, ci;
    decode(k0, dh, dw, ci);
    unsigned short va[4][8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool kin = k0 + e < K;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ih = rih[j] + dh, iw = riw[j] + dw;
        const bool ok = kin && (unsigned)ih < (unsigned)g.H && (unsigned)iw < (unsigned)g.W;
        va[j][e] = ok ? xs[rbase[j] + (ih * g.W + iw) * g.Cin + ci] : (unsigned short)0;
      }
      if (++ci == g.Cin) {
        ci = 0;
        if (++dw == g.kw) {
          dw = 0;
          ++dh;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ga[j] = make_uint4(pack2(va[j][0], va[j][1]), pack2(va[j][2], va[j][3]),
                         pack2(va[j][4], va[j][5]), pack2(va[j][6], va[j][7]));
#pragma unroll
    for (int j = 0; j < C::B_PASSES; ++j) {
      const int kk = slice * BK + br + C::B_ROWS * j;
      unsigned short vb[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        vb[e] = (kk < K && bn + e < N) ? ws[(size_t)kk * N + bn + e] : (unsigned short)0;
      gb[j] = make_uint4(pack2(vb[0], vb[1]), pack2(vb[2], vb[3]), pack2(vb[4], vb[5]),
                         pack2(vb[6], vb[7]));
    }
  };
  auto gather_store = [&](int stage) {
    uint8_t* sa = ring + stage * C::STAGE;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(sa + sw128((tid >> 3) + 32 * j, ac)) = ga[j];
#pragma unroll
    for (int j = 0; j < C::B_PASSES; ++j)
      *reinterpret_cast<uint4*>(sa + A_STAGE + b_off(br + C::B_ROWS * j, bc)) = gb[j];
  };
  auto produce = [&](int slice, int stage) {
    if (GATHER) {
      gather_load(slice);
      gather_store(stage);
    } else {
      copy_vector(slice, stage);
    }
  };

  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.0f;

  for (int s = 0; s < stages; ++s) {
    if (s < KT) produce(s, s);
    cp_async_commit();
  }
  const int wg = tid >> 7;  // warpgroup: rows 64*wg .. 64*wg + 63
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % stages;
    cp_async_wait(stages - 1);
    fence_proxy_async();
    __syncthreads();
    fence_proxy_async();
    const uint32_t sa = ring_u + s * C::STAGE;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16)
      Mma<BN>::run(acc, desc(sa + wg * 64 * 128 + 32 * k16, 16, 1024),
                   desc(sa + A_STAGE + k16 * 16 * 128, BK * 128, 1024));
    wgmma_commit();
    const bool refill = kt + stages < KT;
    if (GATHER && refill) gather_load(kt + stages);
    wgmma_wait0();
    fence_acc(acc);
    __syncthreads();
    if (refill) {
      if (GATHER)
        gather_store(s);
      else
        copy_vector(kt + stages, s);
    }
    cp_async_commit();
  }
  cp_async_wait(0);

  // Epilogue. Thread (warp wp, lane l) holds, for each 8-column group i,
  // columns 8i + 2(l%4) + {0, 1} of rows 16wp + l/4 and 16wp + l/4 + 8
  // (acc[4i..4i+1] and acc[4i+2..4i+3]). Round to bf16; sum the rounded
  // values of valid rows per column: the two rows, then the 8 lanes that
  // share the columns (xor 4, 8, 16), then the 8 warps in order; stage the
  // rounded tile in the ring for 16-byte stores.
  const int lane = tid & 31, wp = tid >> 5;
  const int r0 = 16 * wp + (lane >> 2);
  const bool v0 = m0 + r0 < M, v1 = m0 + r0 + 8 < M;
  constexpr int RB = BN * 2;  // bytes of a staged row
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
    const float2 fl = __bfloat1622float2(lo), fh = __bfloat1622float2(hi);
    float sa = (v0 ? fl.x : 0.0f) + (v1 ? fh.x : 0.0f);
    float sb = (v0 ? fl.y : 0.0f) + (v1 ? fh.y : 0.0f);
    float qa = (v0 ? fl.x * fl.x : 0.0f) + (v1 ? fh.x * fh.x : 0.0f);
    float qb = (v0 ? fl.y * fl.y : 0.0f) + (v1 ? fh.y * fh.y : 0.0f);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      sb += __shfl_xor_sync(0xffffffffu, sb, o);
      qa += __shfl_xor_sync(0xffffffffu, qa, o);
      qb += __shfl_xor_sync(0xffffffffu, qb, o);
    }
    if (lane < 4) {
      const int c = 8 * i + 2 * lane;
      red[0][wp][c] = sa;
      red[0][wp][c + 1] = sb;
      red[1][wp][c] = qa;
      red[1][wp][c + 1] = qb;
    }
    const uint32_t in_chunk = 4 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(ring + r0 * RB + (((i ^ (r0 & 7))) << 4) + in_chunk) = lo;
    *reinterpret_cast<__nv_bfloat162*>(ring + (r0 + 8) * RB + (((i ^ (r0 & 7))) << 4) +
                                       in_chunk) = hi;
  }
  __syncthreads();
  const bool vec_store = (N & 7) == 0;
  for (int idx = tid; idx < BM * C::CH; idx += NT) {
    const int r = idx / C::CH, c = idx - r * C::CH;
    const int m = m0 + r, n = n0 + 8 * c;
    if (m >= M || n >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(ring + r * RB + ((c ^ (r & 7)) << 4));
    __nv_bfloat16* dst = y + (size_t)m * N + n;
    if (vec_store) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      for (int j = 0; j < 8 && n + j < N; ++j) dst[j] = e[j];
    }
  }
  if (tid < 2 * BN) {
    const int which = tid / BN, c = tid - which * BN, n = n0 + c;
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) s += red[which][q][c];
    if (n < N) (which == 0 ? part1 : part2)[(size_t)mt * N + n] = s;
  }
}

template <class Kernels, int BN, bool GATHER>
cudaError_t launch_bn(const void* x, const void* w, void* y, float* part1, float* part2,
                      const Geom& g, int M, int K, int N, int stages, cudaStream_t stream) {
  const int smem = ring_bytes(BN, stages);
  const KernelFn kern = Kernels::template kernel<BN, GATHER>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  kern<<<(unsigned)tiles, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), part1, part2, g, M, K, N, stages);
  return cudaGetLastError();
}

// variant: 1 = vector producer, 2 = gather producer; bn: 64 or 128; stages:
// 1 .. MAX_STAGES. The vector producer needs Cin % 8 == 0, N % 8 == 0 and
// 16-byte aligned x and w.
template <class Kernels>
cudaError_t launch(int variant, int bn, int stages, const void* x, const void* w, void* y,
                   float* part1, float* part2, const Geom& g, int M, int K, int N,
                   cudaStream_t stream) {
  if (stages < 1 || stages > MAX_STAGES) return cudaErrorInvalidValue;
  if (variant == 1) {
    if (g.Cin % 8 != 0 || N % 8 != 0 ||
        ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) != 0)
      return cudaErrorInvalidValue;
    if (bn == 64) return launch_bn<Kernels, 64, false>(x, w, y, part1, part2, g, M, K, N, stages, stream);
    if (bn == 128) return launch_bn<Kernels, 128, false>(x, w, y, part1, part2, g, M, K, N, stages, stream);
  } else if (variant == 2) {
    if (bn == 64) return launch_bn<Kernels, 64, true>(x, w, y, part1, part2, g, M, K, N, stages, stream);
    if (bn == 128) return launch_bn<Kernels, 128, true>(x, w, y, part1, part2, g, M, K, N, stages, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace tc

// -- second stage of a column reduction -------------------------------------
//
// dst row z [n] = sum over i < count of src[(z*chunk + i) * stride][n], for
// chunk z = blockIdx.z and two arrays at once (blockIdx.y picks which);
// count = min(chunk, rows - z*chunk). A block is 32 columns x 8 lanes;
// lane l sums i = l, l+8, ... and the 8 lane sums are combined in order.
constexpr int CS_COLS = 32;
constexpr int CS_LANES = 8;

__global__ void __launch_bounds__(CS_COLS * CS_LANES) column_sums(
    const float* __restrict__ src_a, const float* __restrict__ src_b, float* dst_a,
    float* dst_b, int rows, int stride, int chunk, int dst_stride, int N) {
  __shared__ float red[CS_LANES][CS_COLS];
  const float* src = blockIdx.y == 0 ? src_a : src_b;
  float* dst = blockIdx.y == 0 ? dst_a : dst_b;
  const int c = threadIdx.x % CS_COLS, l = threadIdx.x / CS_COLS;
  const int n = blockIdx.x * CS_COLS + c;
  const int first = blockIdx.z * chunk;
  const int count = min(chunk, rows - first);
  float s = 0.0f;
  if (n < N)
    for (int i = l; i < count; i += CS_LANES) s += src[(size_t)(first + i) * stride * N + n];
  red[l][c] = s;
  __syncthreads();  // every read of the chunk is done: dst may be its first row
  if (l == 0 && n < N) {
    float t = 0.0f;
    for (int i = 0; i < CS_LANES; ++i) t += red[i][c];
    dst[(size_t)blockIdx.z * dst_stride * N + n] = t;
  }
}

// out[n] = sum over p < P of part[p][n], for two arrays at once. With
// chunk_rows > 0 and P > chunk_rows (the conv kernels, whose P is one row
// per 128-row tile, up to 12,544 at the stem) the sum is spread over many
// blocks: a first launch sums each chunk of chunk_rows rows into the
// chunk's own first row (in place: part is scratch), a second sums those
// rows. Either way the order is fixed by P and chunk_rows alone.
inline cudaError_t launch_column_sums(float* part_a, float* part_b, float* out_a,
                                      float* out_b, int P, int N, cudaStream_t stream,
                                      int chunk_rows = 0) {
  const unsigned cols = (N + CS_COLS - 1) / CS_COLS;
  if (chunk_rows > 0 && P > chunk_rows) {
    const int Z = (P + chunk_rows - 1) / chunk_rows;
    column_sums<<<dim3(cols, 2, Z), CS_COLS * CS_LANES, 0, stream>>>(
        part_a, part_b, part_a, part_b, P, 1, chunk_rows, chunk_rows, N);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    column_sums<<<dim3(cols, 2, 1), CS_COLS * CS_LANES, 0, stream>>>(
        part_a, part_b, out_a, out_b, Z, chunk_rows, Z, 0, N);
  } else {
    column_sums<<<dim3(cols, 2, 1), CS_COLS * CS_LANES, 0, stream>>>(
        part_a, part_b, out_a, out_b, P, 1, P, 0, N);
  }
  return cudaGetLastError();
}

// Both engines, then the second stage: dtype 0 (f32) takes `simt_launch`
// (variant 0), dtype 1 (bf16) the tensor-core engine (variant 1 or 2) with
// the caller's `Kernels`.
// tile_rows is the caller's rows per tile, which sized `part` [2, P, N].
template <class Kernels, typename SimtLaunch>
cudaError_t launch_conv_stats(int dtype, int variant, int bn, int stages, int tile_rows,
                                     SimtLaunch simt_launch, const void* x, const void* w,
                                     void* y, void* s1, void* s2, void* part, const Geom& g,
                                     int M, int K, int N, cudaStream_t stream) {
  if (tile_rows != TILE_M) return cudaErrorInvalidValue;
  const int P = (M + TILE_M - 1) / TILE_M;
  float* part1 = static_cast<float*>(part);
  float* part2 = part1 + (size_t)P * N;
  cudaError_t e;
  if (dtype == 0 && variant == 0)
    e = simt_launch(part1, part2);
  else if (dtype == 1 && variant != 0)
    e = tc::launch<Kernels>(variant, bn, stages, x, w, y, part1, part2, g, M, K, N, stream);
  else
    return cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  return launch_column_sums(part1, part2, static_cast<float*>(s1), static_cast<float*>(s2), P,
                            N, stream, /*chunk_rows=*/256);
}

}  // namespace convbn
}  // namespace dl4j
