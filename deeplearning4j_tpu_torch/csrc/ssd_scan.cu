// The SSD chunked scan of a Mamba-2 layer (Dao & Gu, arXiv:2405.21060, §6),
// forward and backward, as seven kernels:
//   forward   ssd_chunk_state_kernel    each chunk's own state
//                                       S = (x o w)^T B, w_s = exp(l_last - l_s) dt_s
//             ssd_state_pass_kernel     the states passed on in chunk order,
//                                       written in place as each chunk's S_in
//             ssd_chunk_scan_kernel     each chunk's outputs: exp(l_t) C S_in^T,
//                                       ((C B^T) o L o dt) x and D x
//   backward  ssd_bwd_dstate_kernel     each chunk's dS from its outputs,
//                                       (dy o exp(l))^T C
//             ssd_state_pass_bwd_kernel dS_out passed back in reverse chunk
//                                       order, and the decay's gradient at
//                                       each chunk end
//             ssd_bwd_dx_kernel         by columns s: dx, dB (per head), ddt
//                                       and the decay's gradient at s
//             ssd_bwd_dc_kernel         by rows t: dC (per head) and the
//                                       decay's gradient at t
// l is the chunk-local cumulative sum of dt A (f32, computed by torch so
// that autograd carries its gradient to dt and A). The wrapper and the plain
// version of the same algebra are in ops/fused_ssd.py.
//
// Replaces no TPU kernel: the JAX package has no state-space layer.
//
// What bounds it on an H100: the intra-chunk products, 2QN + 2QP
// multiply-adds a token and head forward at chunk Q 256, state N 128 and
// head width P 64, about 32 FLOP a byte in bf16; the passing kernels walk
// the chunks in order, a chain of dependent steps.
//
// Design: one block of 8 warps a (chunk, head) or a (chunk, head, 64-row
// tile). Tiles are staged in shared memory as bf16 with padded
// rows, and the products run on the tensor cores through WMMA 16x16x16
// fragments with f32 accumulation; a warp keeps up to 4 accumulator tiles
// of a product in registers across the loop over the chunk's other tiles,
// in row order so that they share the row's A fragment. The row
// scalings of the state terms are folded into copies of the operands. Each
// [Q, Q] score tile is made in shared memory (f32), masked and decayed
// there, rounded to the operand type and fed to the next product: no score
// or decay tensor is written to device memory, and the backward keeps only
// its inputs and the chunk-boundary states. dB and dC are written per head
// (f32) and summed over the heads of a group by the wrapper; the decay's
// gradient at the chunk ends is written per warp of the passing kernel and
// summed there too: no atomics, every sum in a fixed order, so a replayed
// graph gives the same bits.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int NT = 256;        // threads a block
constexpr int NW = NT / 32;    // warps a block
// accumulator tiles a warp holds of an output [P, N] (at most 4 x 8 tiles),
// [bt, N] (4 x 8), [bt, P] and [bt, bt] (4 x 4), with bt <= 64, P <= 64 and
// N <= 128
constexpr int T_PN = 4, T_BN = 4, T_BP = 2, T_BB = 2;
constexpr int PASS = 256;      // state elements a block of the passing kernels
constexpr int UNROLL = 8;      // chunks a passing thread loads ahead
constexpr int SMEM_MAX = 232448;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <typename T>
__device__ __forceinline__ float f32(T v);
template <>
__device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T cvt(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Padded row lengths of the shared tiles (16 bytes more a row).
__host__ __device__ constexpr int ldh(int cols) { return cols + 8; }
__host__ __device__ constexpr int ldf(int cols) { return cols + 4; }

// Byte offsets into the dynamic shared memory, each 128-byte aligned.
struct Carve {
  int off = 0;
  __host__ __device__ int take(int bytes) {
    int o = off;
    off += (bytes + 127) & ~127;
    return o;
  }
};

// The warp's tiles idx = base + j (j < TPW; those at or past `total` are
// idle) of an output `tn` tiles wide, in row-major order, so that
// consecutive tiles share their row's A fragment: acc[j] += A[16 i.., :K] .
// B[:K, 16 c..]. A is row-major (a[m * lda + k]) or, with AT, stored
// transposed (a[k * lda + m]); B is row-major (b[k * ldb + n]) or, with BT,
// stored transposed (b[n * ldb + k]).
template <typename T, bool AT, bool BT, int TPW>
__device__ __forceinline__ void mma_tiles(Acc (&acc)[TPW], const T* a, int lda, const T* b,
                                          int ldb, int base, int total, int tn, int K) {
  using LA = std::conditional_t<AT, wmma::col_major, wmma::row_major>;
  using LB = std::conditional_t<BT, wmma::col_major, wmma::row_major>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> fb;
  for (int k = 0; k < K; k += 16) {
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int idx = base + j;
      if (idx < total) {
        const int i = idx / tn, c = idx % tn;
        if (j == 0 || c == 0)
          wmma::load_matrix_sync(fa, AT ? a + 16 * i + k * lda : a + 16 * i * lda + k, lda);
        wmma::load_matrix_sync(fb, BT ? b + 16 * c * ldb + k : b + k * ldb + 16 * c, ldb);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
}

template <int TPW>
__device__ __forceinline__ void zero(Acc (&acc)[TPW]) {
#pragma unroll
  for (int j = 0; j < TPW; ++j) wmma::fill_fragment(acc[j], 0.0f);
}

// The warp's tiles (as in mma_tiles) stored to out, `ld` floats a row, or
// loaded from it.
template <int TPW>
__device__ __forceinline__ void store_tiles(float* out, size_t ld, Acc (&acc)[TPW], int base,
                                            int total, int tn) {
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int idx = base + j;
    if (idx < total)
      wmma::store_matrix_sync(out + (idx / tn) * 16 * ld + (idx % tn) * 16, acc[j],
                              static_cast<unsigned>(ld), wmma::mem_row_major);
  }
}

template <int TPW>
__device__ __forceinline__ void load_tiles(Acc (&acc)[TPW], const float* in, int ld, int base,
                                           int total, int tn) {
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int idx = base + j;
    if (idx < total)
      wmma::load_matrix_sync(acc[j], in + (idx / tn) * 16 * ld + (idx % tn) * 16, ld,
                             wmma::mem_row_major);
  }
}

// out = A . B (f32, `ldo` a row) over the warp's tiles.
template <typename T, bool AT, bool BT, int TPW>
__device__ __forceinline__ void product_to(float* out, int ldo, const T* a, int lda, const T* b,
                                           int ldb, int base, int total, int tn, int K) {
  Acc f[TPW];
  zero(f);
  mma_tiles<T, AT, BT, TPW>(f, a, lda, b, ldb, base, total, tn, K);
  store_tiles(out, ldo, f, base, total, tn);
}

// rows x cols 16-bit values from global rows `gstride` apart into a shared
// tile, 16 bytes a thread; with `scale`, each row times scale[row] (f32,
// rounded back to T).
template <typename T>
__device__ __forceinline__ void load_rows(T* s, int lds, const T* g, size_t gstride, int rows,
                                          int cols, const float* scale = nullptr) {
  const int vpr = cols / 8;
  for (int i = threadIdx.x; i < rows * vpr; i += NT) {
    const int r = i / vpr, v = i % vpr;
    uint4 u = *reinterpret_cast<const uint4*>(g + r * gstride + v * 8);
    if (scale != nullptr) {
      T* e = reinterpret_cast<T*>(&u);
      const float sc = scale[r];
#pragma unroll
      for (int q = 0; q < 8; ++q) e[q] = cvt<T>(f32(e[q]) * sc);
    }
    *reinterpret_cast<uint4*>(s + r * lds + v * 8) = u;
  }
}

// A [P, N] f32 state in device memory into a shared T tile.
template <typename T>
__device__ __forceinline__ void load_state(T* s, int lds, const float* g, int P, int N) {
  for (int i = threadIdx.x; i < P * N / 4; i += NT) {
    const int p = (4 * i) / N, n = (4 * i) % N;
    const float4 v = *reinterpret_cast<const float4*>(g + 4 * i);
    T* d = s + p * lds + n;
    d[0] = cvt<T>(v.x);
    d[1] = cvt<T>(v.y);
    d[2] = cvt<T>(v.z);
    d[3] = cvt<T>(v.w);
  }
}

// Sum over the `tpr` neighbouring lanes that share a row (tpr a power of
// two dividing 32).
__device__ __forceinline__ float row_sum(float v, int tpr) {
  for (int o = tpr / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Dims {
  int T, H, G, NC, Q, P, N, bt;
};

// ---- the chunk states: ssd_chunk_state (x, w = exp(l_last - l) dt, B) and
// ssd_bwd_dstate (dy, w = exp(l), C). out [B, NC, H, P, N] f32.
struct OuterLayout {
  int a, b, w, total;
  __host__ __device__ OuterLayout(int P, int N, int bt) {
    Carve c;
    a = c.take(bt * ldh(P) * 2);
    b = c.take(bt * ldh(N) * 2);
    w = c.take(bt * 4);
    total = c.off;
  }
};

template <typename T, bool STATE>
__device__ __forceinline__ void chunk_outer(const T* __restrict__ xin, const float* __restrict__ dt,
                                            const float* __restrict__ l,
                                            const T* __restrict__ bin, float* __restrict__ out,
                                            Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const OuterLayout L(d.P, d.N, d.bt);
  T* sa = reinterpret_cast<T*>(smem + L.a);
  T* sb = reinterpret_cast<T*>(smem + L.b);
  float* sw = reinterpret_cast<float*>(smem + L.w);
  const int b = blockIdx.x / d.NC, c = blockIdx.x % d.NC, h = blockIdx.y;
  const int g = h / (d.H / d.G), base = (threadIdx.x / 32) * T_PN;
  const size_t t0 = static_cast<size_t>(b) * d.T + static_cast<size_t>(c) * d.Q;
  const float l_last = l[(t0 + d.Q - 1) * d.H + h];
  const int tn = d.N / 16, total = (d.P / 16) * tn;
  Acc acc[T_PN];
  zero(acc);
  for (int k0 = 0; k0 < d.Q; k0 += d.bt) {
    for (int i = threadIdx.x; i < d.bt; i += NT) {
      const size_t at = (t0 + k0 + i) * d.H + h;
      sw[i] = STATE ? __expf(l_last - l[at]) * dt[at] : __expf(l[at]);
    }
    __syncthreads();
    load_rows(sa, ldh(d.P), xin + ((t0 + k0) * d.H + h) * d.P,
              static_cast<size_t>(d.H) * d.P, d.bt, d.P, sw);
    load_rows(sb, ldh(d.N), bin + ((t0 + k0) * d.G + g) * d.N,
              static_cast<size_t>(d.G) * d.N, d.bt, d.N);
    __syncthreads();
    mma_tiles<T, true, false, T_PN>(acc, sa, ldh(d.P), sb, ldh(d.N), base, total, tn, d.bt);
    __syncthreads();
  }
  store_tiles(out + ((static_cast<size_t>(b) * d.NC + c) * d.H + h) * d.P * d.N, d.N, acc, base,
              total, tn);
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_chunk_state_kernel(const T* x, const float* dt,
                                                             const float* l, const T* Bm,
                                                             float* states, Dims d) {
  chunk_outer<T, true>(x, dt, l, Bm, states, d);
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_dstate_kernel(const T* dy, const float* l,
                                                            const T* Cm, float* dsy, Dims d) {
  chunk_outer<T, false>(dy, nullptr, l, Cm, dsy, d);
}

// ---- the passing: S_in of chunk c = exp(l_last[c-1]) S_in[c-1] + S[c-1],
// in place over the chunk states [B, NC, H, P*N].
__global__ void __launch_bounds__(PASS) ssd_state_pass_kernel(float* st, const float* ll,
                                                              int H, int NC, int PN) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int e = blockIdx.y * PASS + threadIdx.x;
  if (e >= PN) return;
  float s = 0.0f;
  for (int c0 = 0; c0 < NC; c0 += UNROLL) {
    float own[UNROLL], dec[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c0 + u < NC) {
        const size_t bc = static_cast<size_t>(b) * NC + c0 + u;
        own[u] = st[(bc * H + h) * PN + e];
        dec[u] = __expf(ll[bc * H + h]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c0 + u < NC) {
        const size_t bc = static_cast<size_t>(b) * NC + c0 + u;
        st[(bc * H + h) * PN + e] = s;
        s = dec[u] * s + own[u];
      }
    }
  }
}

// ---- the passing back: dS_out of chunk c = exp(l_last[c+1]) dS_out[c+1] +
// dS[c+1], in place over dS; dll[b, c, h, part] = exp(l_last[c]) *
// sum(dS_out[c] o S_in[c]) over the part's 32 elements.
__global__ void __launch_bounds__(PASS) ssd_state_pass_bwd_kernel(float* dsy, const float* st,
                                                                  const float* ll, float* dll,
                                                                  int H, int NC, int PN,
                                                                  int parts) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int e = blockIdx.y * PASS + threadIdx.x;
  const bool valid = e < PN;
  const int part = blockIdx.y * (PASS / 32) + threadIdx.x / 32;
  float ds = 0.0f;
  for (int i0 = 0; i0 < NC; i0 += UNROLL) {
    float own[UNROLL], s_in[UNROLL], dec[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = NC - 1 - i0 - u;
      if (c >= 0) {
        const size_t bc = static_cast<size_t>(b) * NC + c;
        own[u] = valid ? dsy[(bc * H + h) * PN + e] : 0.0f;
        s_in[u] = valid ? st[(bc * H + h) * PN + e] : 0.0f;
        dec[u] = __expf(ll[bc * H + h]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = NC - 1 - i0 - u;
      if (c >= 0) {
        const size_t bc = static_cast<size_t>(b) * NC + c;
        if (valid) dsy[(bc * H + h) * PN + e] = ds;
        const float v = row_sum(ds * s_in[u], 32);
        if (threadIdx.x % 32 == 0) dll[(bc * H + h) * parts + part] = dec[u] * v;
        ds = dec[u] * ds + own[u];
      }
    }
  }
}

// ---- the chunk outputs, a block a (chunk, head, bt rows t).
struct ScanLayout {
  int ct, sin, yacc, bs, xs, cb, cbh, lt, ls, dts, total;
  __host__ __device__ ScanLayout(int P, int N, int bt) {
    Carve c;
    ct = c.take(bt * ldh(N) * 2);
    sin = c.take(P * ldh(N) * 2);
    yacc = c.take(bt * ldf(P) * 4);
    bs = c.take(bt * ldh(N) * 2);
    xs = c.take(bt * ldh(P) * 2);
    cb = c.take(bt * ldf(bt) * 4);
    cbh = c.take(bt * ldh(bt) * 2);
    lt = c.take(bt * 4);
    ls = c.take(bt * 4);
    dts = c.take(bt * 4);
    total = c.off;
  }
};

template <typename T>
__global__ void __launch_bounds__(NT) ssd_chunk_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ l,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ states,
    const float* __restrict__ D, T* __restrict__ y, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bt = d.bt, P = d.P, N = d.N;
  const ScanLayout L(P, N, bt);
  T* ct = reinterpret_cast<T*>(smem + L.ct);
  T* sin = reinterpret_cast<T*>(smem + L.sin);
  float* yacc = reinterpret_cast<float*>(smem + L.yacc);
  T* bs = reinterpret_cast<T*>(smem + L.bs);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  float* cb = reinterpret_cast<float*>(smem + L.cb);
  T* cbh = reinterpret_cast<T*>(smem + L.cbh);
  float* lt = reinterpret_cast<float*>(smem + L.lt);
  float* ls = reinterpret_cast<float*>(smem + L.ls);
  float* dts = reinterpret_cast<float*>(smem + L.dts);
  const int b = blockIdx.x / d.NC, c = blockIdx.x % d.NC, h = blockIdx.y;
  const int m0 = blockIdx.z * bt, g = h / (d.H / d.G), warp = threadIdx.x / 32;
  const size_t t0 = static_cast<size_t>(b) * d.T + static_cast<size_t>(c) * d.Q;
  const size_t xrow = static_cast<size_t>(d.H) * P, brow = static_cast<size_t>(d.G) * N;
  load_rows(ct, ldh(N), Cm + ((t0 + m0) * d.G + g) * N, brow, bt, N);
  load_state(sin, ldh(N), states + ((static_cast<size_t>(b) * d.NC + c) * d.H + h) * P * N, P, N);
  for (int i = threadIdx.x; i < bt; i += NT) lt[i] = l[(t0 + m0 + i) * d.H + h];
  __syncthreads();
  const int tp = P / 16, ty = (bt / 16) * tp, tq = bt / 16;
  const int by = warp * T_BP, bq = warp * T_BB;
  // the inter-chunk term exp(l_t) C_t S_in^T, scaled in f32
  Acc acc[T_BP];
  zero(acc);
  mma_tiles<T, false, true, T_BP>(acc, ct, ldh(N), sin, ldh(N), by, ty, tp, N);
  store_tiles(yacc, ldf(P), acc, by, ty, tp);
  __syncthreads();
  for (int i = threadIdx.x; i < bt * P; i += NT) yacc[(i / P) * ldf(P) + i % P] *= __expf(lt[i / P]);
  __syncthreads();
  load_tiles(acc, yacc, ldf(P), by, ty, tp);
  // the intra-chunk term over the column tiles s <= t
  for (int k0 = 0; k0 <= m0; k0 += bt) {
    load_rows(bs, ldh(N), Bm + ((t0 + k0) * d.G + g) * N, brow, bt, N);
    load_rows(xs, ldh(P), x + ((t0 + k0) * d.H + h) * P, xrow, bt, P);
    for (int i = threadIdx.x; i < bt; i += NT) {
      ls[i] = l[(t0 + k0 + i) * d.H + h];
      dts[i] = dt[(t0 + k0 + i) * d.H + h];
    }
    __syncthreads();
    product_to<T, false, true, T_BB>(cb, ldf(bt), ct, ldh(N), bs, ldh(N), bq, tq * tq, tq, N);
    __syncthreads();
    for (int i = threadIdx.x; i < bt * bt; i += NT) {
      const int r = i / bt, s = i % bt;
      float v = 0.0f;
      if (m0 + r >= k0 + s)
        v = cb[r * ldf(bt) + s] * __expf(fminf(lt[r] - ls[s], 0.0f)) * dts[s];
      cbh[r * ldh(bt) + s] = cvt<T>(v);
    }
    __syncthreads();
    mma_tiles<T, false, false, T_BP>(acc, cbh, ldh(bt), xs, ldh(P), by, ty, tp, bt);
    __syncthreads();
  }
  store_tiles(yacc, ldf(P), acc, by, ty, tp);
  __syncthreads();
  const float dh = D[h];
  for (int i = threadIdx.x; i < bt * P; i += NT) {
    const int r = i / P, p = i % P;
    const size_t at = ((t0 + m0 + r) * d.H + h) * P + p;
    y[at] = cvt<T>(yacc[r * ldf(P) + p] + dh * f32(x[at]));
  }
}

// ---- dx, dB (per head), ddt and the decay's gradient at s, a block a
// (chunk, head, bt columns s), over the row tiles t >= s. With w_s =
// exp(l_last - l_s) dt_s: dx_s = sum_t dt_s gl[s, t] dy_t + w_s B_s dS_out^T
// + D dy_s, dB_s = sum_t dg[s, t] C_t + w_s x_s dS_out, the row scalings
// folded into the products' operands.
struct DxLayout {
  int bs, xs, ls, dts, addt, ct, dyt, cb, dyx, glh, dgh, lt, dso, wb, wx, fx, bds, total;
  __host__ __device__ DxLayout(int P, int N, int bt) {
    Carve c;
    bs = c.take(bt * ldh(N) * 2);
    xs = c.take(bt * ldh(P) * 2);
    ls = c.take(bt * 4);
    dts = c.take(bt * 4);
    addt = c.take(bt * 4);
    const int loop = c.off;  // the loop's tiles, then the end's over them
    ct = c.take(bt * ldh(N) * 2);
    dyt = c.take(bt * ldh(P) * 2);
    cb = c.take(bt * ldf(bt) * 4);
    dyx = c.take(bt * ldf(bt) * 4);
    glh = c.take(bt * ldh(bt) * 2);
    dgh = c.take(bt * ldh(bt) * 2);
    lt = c.take(bt * 4);
    const int loop_end = c.off;
    c.off = loop;
    dso = c.take(P * ldh(N) * 2);
    wb = c.take(bt * ldh(N) * 2);
    wx = c.take(bt * ldh(P) * 2);
    fx = c.take(bt * ldf(P) * 4);
    bds = c.take(bt * ldf(P) * 4);
    total = c.off > loop_end ? c.off : loop_end;
  }
};

template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_dx_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ l,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ dso_g,
    const float* __restrict__ D, const T* __restrict__ dy, T* __restrict__ dx,
    float* __restrict__ dbh, float* __restrict__ ddt, float* __restrict__ dlc,
    float* __restrict__ kk, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bt = d.bt, P = d.P, N = d.N;
  const DxLayout L(P, N, bt);
  T* bs = reinterpret_cast<T*>(smem + L.bs);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  float* ls = reinterpret_cast<float*>(smem + L.ls);
  float* dts = reinterpret_cast<float*>(smem + L.dts);
  float* addt = reinterpret_cast<float*>(smem + L.addt);
  T* ct = reinterpret_cast<T*>(smem + L.ct);
  T* dyt = reinterpret_cast<T*>(smem + L.dyt);
  float* cb = reinterpret_cast<float*>(smem + L.cb);
  float* dyx = reinterpret_cast<float*>(smem + L.dyx);
  T* glh = reinterpret_cast<T*>(smem + L.glh);
  T* dgh = reinterpret_cast<T*>(smem + L.dgh);
  float* lt = reinterpret_cast<float*>(smem + L.lt);
  const int b = blockIdx.x / d.NC, c = blockIdx.x % d.NC, h = blockIdx.y;
  const int k0 = blockIdx.z * bt, g = h / (d.H / d.G), warp = threadIdx.x / 32;
  const size_t t0 = static_cast<size_t>(b) * d.T + static_cast<size_t>(c) * d.Q;
  const size_t xrow = static_cast<size_t>(d.H) * P, brow = static_cast<size_t>(d.G) * N;
  load_rows(bs, ldh(N), Bm + ((t0 + k0) * d.G + g) * N, brow, bt, N);
  load_rows(xs, ldh(P), x + ((t0 + k0) * d.H + h) * P, xrow, bt, P);
  for (int i = threadIdx.x; i < bt; i += NT) {
    ls[i] = l[(t0 + k0 + i) * d.H + h];
    dts[i] = dt[(t0 + k0 + i) * d.H + h];
  }
  const int tp = P / 16, tn = N / 16, tq = bt / 16;
  const int bx = warp * T_BP, bb = warp * T_BN, bq = warp * T_BB;
  const int tpr = NT / bt, row = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  Acc accx[T_BP], accb[T_BN];
  zero(accx);
  zero(accb);
  float part = 0.0f;  // this thread's share of sum_t gl[s, t] dyx[s, t], s = row
  for (int m0 = k0; m0 < d.Q; m0 += bt) {
    load_rows(ct, ldh(N), Cm + ((t0 + m0) * d.G + g) * N, brow, bt, N);
    load_rows(dyt, ldh(P), dy + ((t0 + m0) * d.H + h) * P, xrow, bt, P);
    for (int i = threadIdx.x; i < bt; i += NT) lt[i] = l[(t0 + m0 + i) * d.H + h];
    __syncthreads();
    // cb[s, t] = B_s . C_t and dyx[s, t] = x_s . dy_t
    product_to<T, false, true, T_BB>(cb, ldf(bt), bs, ldh(N), ct, ldh(N), bq, tq * tq, tq, N);
    product_to<T, false, true, T_BB>(dyx, ldf(bt), xs, ldh(P), dyt, ldh(P), bq, tq * tq, tq, P);
    __syncthreads();
    const float dts_r = dts[row], ls_r = ls[row];
    for (int q = lane; q < bt; q += tpr) {
      const bool causal = m0 + q >= k0 + row;
      const float dec = causal ? __expf(fminf(lt[q] - ls_r, 0.0f)) : 0.0f;
      const float gl = cb[row * ldf(bt) + q] * dec, v = dyx[row * ldf(bt) + q];
      part += gl * v;
      glh[row * ldh(bt) + q] = cvt<T>(gl * dts_r);
      dgh[row * ldh(bt) + q] = cvt<T>(dec * v * dts_r);
    }
    __syncthreads();
    mma_tiles<T, false, false, T_BP>(accx, glh, ldh(bt), dyt, ldh(P), bx, tq * tp, tp, bt);
    mma_tiles<T, false, false, T_BN>(accb, dgh, ldh(bt), ct, ldh(N), bb, tq * tn, tn, bt);
    __syncthreads();
  }
  part = row_sum(part, tpr);
  if (lane == 0) addt[row] = part;
  // the state terms, with w_s folded into copies of B_s and x_s
  T* dso = reinterpret_cast<T*>(smem + L.dso);
  T* wb = reinterpret_cast<T*>(smem + L.wb);
  T* wx = reinterpret_cast<T*>(smem + L.wx);
  float* fx = reinterpret_cast<float*>(smem + L.fx);
  float* bds = reinterpret_cast<float*>(smem + L.bds);
  const float l_last = l[(t0 + d.Q - 1) * d.H + h];
  load_state(dso, ldh(N), dso_g + ((static_cast<size_t>(b) * d.NC + c) * d.H + h) * P * N, P, N);
  for (int i = threadIdx.x; i < bt * N; i += NT) {
    const int r = i / N, n = i % N;
    wb[r * ldh(N) + n] = cvt<T>(__expf(l_last - ls[r]) * dts[r] * f32(bs[r * ldh(N) + n]));
  }
  for (int i = threadIdx.x; i < bt * P; i += NT) {
    const int r = i / P, p = i % P;
    wx[r * ldh(P) + p] = cvt<T>(__expf(l_last - ls[r]) * dts[r] * f32(xs[r * ldh(P) + p]));
  }
  __syncthreads();
  mma_tiles<T, false, true, T_BP>(accx, wb, ldh(N), dso, ldh(N), bx, tq * tp, tp, N);
  mma_tiles<T, false, false, T_BN>(accb, wx, ldh(P), dso, ldh(N), bb, tq * tn, tn, P);
  store_tiles(dbh + ((t0 + k0) * d.H + h) * N, static_cast<size_t>(d.H) * N, accb, bb, tq * tn,
              tn);
  store_tiles(fx, ldf(P), accx, bx, tq * tp, tp);
  product_to<T, false, true, T_BP>(bds, ldf(P), bs, ldh(N), dso, ldh(N), bx, tq * tp, tp, N);
  __syncthreads();
  const float dh = D[h];
  const float e = __expf(l_last - ls[row]), w = e * dts[row];
  const size_t s = t0 + k0 + row;
  float dw = 0.0f;  // x_s . (B_s dS_out^T)
  for (int p = lane; p < P; p += tpr) {
    const size_t at = (s * d.H + h) * P + p;
    dw += f32(xs[row * ldh(P) + p]) * bds[row * ldf(P) + p];
    dx[at] = cvt<T>(fx[row * ldf(P) + p] + dh * f32(dy[at]));
  }
  dw = row_sum(dw, tpr);
  if (lane == 0) {
    const float a = addt[row];
    ddt[s * d.H + h] = a + e * dw;
    dlc[s * d.H + h] = a * dts[row] + w * dw;
    kk[s * d.H + h] = w * dw;
  }
}

// ---- dC (per head) and the decay's gradient at t, a block a (chunk, head,
// bt rows t), over the column tiles s <= t: dC_t = sum_s dg[t, s] B_s +
// exp(l_t) dy_t S_in, the row scaling folded into a copy of dy_t.
struct DcLayout {
  int ct, dyt, lt, adl, bs, xs, ls, dts, dyx, cb, dgh, sin, edy, cs, total;
  __host__ __device__ DcLayout(int P, int N, int bt) {
    Carve c;
    ct = c.take(bt * ldh(N) * 2);
    dyt = c.take(bt * ldh(P) * 2);
    lt = c.take(bt * 4);
    adl = c.take(bt * 4);
    const int loop = c.off;
    bs = c.take(bt * ldh(N) * 2);
    xs = c.take(bt * ldh(P) * 2);
    ls = c.take(bt * 4);
    dts = c.take(bt * 4);
    dyx = c.take(bt * ldf(bt) * 4);
    cb = c.take(bt * ldf(bt) * 4);
    dgh = c.take(bt * ldh(bt) * 2);
    const int loop_end = c.off;
    c.off = loop;
    sin = c.take(P * ldh(N) * 2);
    edy = c.take(bt * ldh(P) * 2);
    cs = c.take(bt * ldf(P) * 4);
    total = c.off > loop_end ? c.off : loop_end;
  }
};

template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_dc_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ l,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ states,
    const T* __restrict__ dy, float* __restrict__ dch, float* __restrict__ dlr, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bt = d.bt, P = d.P, N = d.N;
  const DcLayout L(P, N, bt);
  T* ct = reinterpret_cast<T*>(smem + L.ct);
  T* dyt = reinterpret_cast<T*>(smem + L.dyt);
  float* lt = reinterpret_cast<float*>(smem + L.lt);
  float* adl = reinterpret_cast<float*>(smem + L.adl);
  T* bs = reinterpret_cast<T*>(smem + L.bs);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  float* ls = reinterpret_cast<float*>(smem + L.ls);
  float* dts = reinterpret_cast<float*>(smem + L.dts);
  float* dyx = reinterpret_cast<float*>(smem + L.dyx);
  float* cb = reinterpret_cast<float*>(smem + L.cb);
  T* dgh = reinterpret_cast<T*>(smem + L.dgh);
  const int b = blockIdx.x / d.NC, c = blockIdx.x % d.NC, h = blockIdx.y;
  const int m0 = blockIdx.z * bt, g = h / (d.H / d.G), warp = threadIdx.x / 32;
  const size_t t0 = static_cast<size_t>(b) * d.T + static_cast<size_t>(c) * d.Q;
  const size_t xrow = static_cast<size_t>(d.H) * P, brow = static_cast<size_t>(d.G) * N;
  load_rows(ct, ldh(N), Cm + ((t0 + m0) * d.G + g) * N, brow, bt, N);
  load_rows(dyt, ldh(P), dy + ((t0 + m0) * d.H + h) * P, xrow, bt, P);
  for (int i = threadIdx.x; i < bt; i += NT) lt[i] = l[(t0 + m0 + i) * d.H + h];
  const int tp = P / 16, tn = N / 16, tq = bt / 16;
  const int bc = warp * T_BN, bp = warp * T_BP, bq = warp * T_BB;
  const int tpr = NT / bt, row = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  Acc acc[T_BN];
  zero(acc);
  float part = 0.0f;  // this thread's share of sum_s dg[t, s] cb[t, s], t = row
  for (int k0 = 0; k0 <= m0; k0 += bt) {
    load_rows(bs, ldh(N), Bm + ((t0 + k0) * d.G + g) * N, brow, bt, N);
    load_rows(xs, ldh(P), x + ((t0 + k0) * d.H + h) * P, xrow, bt, P);
    for (int i = threadIdx.x; i < bt; i += NT) {
      ls[i] = l[(t0 + k0 + i) * d.H + h];
      dts[i] = dt[(t0 + k0 + i) * d.H + h];
    }
    __syncthreads();
    // dyx[t, s] = dy_t . x_s and cb[t, s] = C_t . B_s
    product_to<T, false, true, T_BB>(dyx, ldf(bt), dyt, ldh(P), xs, ldh(P), bq, tq * tq, tq, P);
    product_to<T, false, true, T_BB>(cb, ldf(bt), ct, ldh(N), bs, ldh(N), bq, tq * tq, tq, N);
    __syncthreads();
    const float lt_r = lt[row];
    for (int q = lane; q < bt; q += tpr) {
      const bool causal = m0 + row >= k0 + q;
      const float dec = causal ? __expf(fminf(lt_r - ls[q], 0.0f)) : 0.0f;
      const float dg = dec * dts[q] * dyx[row * ldf(bt) + q];
      part += dg * cb[row * ldf(bt) + q];
      dgh[row * ldh(bt) + q] = cvt<T>(dg);
    }
    __syncthreads();
    mma_tiles<T, false, false, T_BN>(acc, dgh, ldh(bt), bs, ldh(N), bc, tq * tn, tn, bt);
    __syncthreads();
  }
  part = row_sum(part, tpr);
  if (lane == 0) adl[row] = part;
  // the state term, and cs = C_t S_in^T for the decay's gradient
  T* sin = reinterpret_cast<T*>(smem + L.sin);
  T* edy = reinterpret_cast<T*>(smem + L.edy);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  load_state(sin, ldh(N), states + ((static_cast<size_t>(b) * d.NC + c) * d.H + h) * P * N, P, N);
  for (int i = threadIdx.x; i < bt * P; i += NT) {
    const int r = i / P, p = i % P;
    edy[r * ldh(P) + p] = cvt<T>(__expf(lt[r]) * f32(dyt[r * ldh(P) + p]));
  }
  __syncthreads();
  mma_tiles<T, false, false, T_BN>(acc, edy, ldh(P), sin, ldh(N), bc, tq * tn, tn, P);
  store_tiles(dch + ((t0 + m0) * d.H + h) * N, static_cast<size_t>(d.H) * N, acc, bc, tq * tn,
              tn);
  product_to<T, false, true, T_BP>(cs, ldf(P), ct, ldh(N), sin, ldh(N), bp, tq * tp, tp, N);
  __syncthreads();
  float cy = 0.0f;  // dy_t . (C_t S_in^T)
  for (int p = lane; p < P; p += tpr) cy += f32(dyt[row * ldh(P) + p]) * cs[row * ldf(P) + p];
  cy = row_sum(cy, tpr);
  if (lane == 0) dlr[(t0 + m0 + row) * d.H + h] = adl[row] + __expf(lt[row]) * cy;
}

int smem_bytes(int P, int N, int Q) {
  const int bt = Q < 64 ? Q : 64;
  int m = OuterLayout(P, N, bt).total;
  m = m > ScanLayout(P, N, bt).total ? m : ScanLayout(P, N, bt).total;
  m = m > DxLayout(P, N, bt).total ? m : DxLayout(P, N, bt).total;
  m = m > DcLayout(P, N, bt).total ? m : DcLayout(P, N, bt).total;
  return m;
}

bool dims_ok(int B, int T, int H, int G, int P, int N, int Q) {
  auto pow2 = [](int v) { return v >= 16 && (v & (v - 1)) == 0; };
  return B >= 1 && T >= Q && H >= 1 && G >= 1 && H % G == 0 && pow2(P) && P <= 64 &&
         pow2(N) && N <= 128 && pow2(Q) && T % Q == 0 && smem_bytes(P, N, Q) <= SMEM_MAX;
}

template <typename K>
void allow_smem(K kernel) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
}

template <typename T>
int forward(const void* x, const void* dt, const void* l, const void* l_last, const void* Bm,
            const void* Cm, const void* D, void* states, void* y, int B, Dims d,
            cudaStream_t s) {
  static bool init = [] {
    allow_smem(ssd_chunk_state_kernel<T>);
    allow_smem(ssd_chunk_scan_kernel<T>);
    return true;
  }();
  (void)init;
  const int PN = d.P * d.N;
  ssd_chunk_state_kernel<T><<<dim3(B * d.NC, d.H), NT, OuterLayout(d.P, d.N, d.bt).total, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(l),
      static_cast<const T*>(Bm), static_cast<float*>(states), d);
  ssd_state_pass_kernel<<<dim3(B * d.H, (PN + PASS - 1) / PASS), PASS, 0, s>>>(
      static_cast<float*>(states), static_cast<const float*>(l_last), d.H, d.NC, PN);
  ssd_chunk_scan_kernel<T>
      <<<dim3(B * d.NC, d.H, d.Q / d.bt), NT, ScanLayout(d.P, d.N, d.bt).total, s>>>(
          static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(l),
          static_cast<const T*>(Bm), static_cast<const T*>(Cm),
          static_cast<const float*>(states), static_cast<const float*>(D), static_cast<T*>(y),
          d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* x, const void* dt, const void* l, const void* l_last, const void* Bm,
             const void* Cm, const void* D, const void* states, const void* dy, void* ds,
             void* dll, void* dx, void* dbh, void* ddt, void* dlc, void* kk, void* dch,
             void* dlr, int B, Dims d, cudaStream_t s) {
  static bool init = [] {
    allow_smem(ssd_bwd_dstate_kernel<T>);
    allow_smem(ssd_bwd_dx_kernel<T>);
    allow_smem(ssd_bwd_dc_kernel<T>);
    return true;
  }();
  (void)init;
  const int PN = d.P * d.N, nblk = (PN + PASS - 1) / PASS;
  ssd_bwd_dstate_kernel<T><<<dim3(B * d.NC, d.H), NT, OuterLayout(d.P, d.N, d.bt).total, s>>>(
      static_cast<const T*>(dy), static_cast<const float*>(l), static_cast<const T*>(Cm),
      static_cast<float*>(ds), d);
  ssd_state_pass_bwd_kernel<<<dim3(B * d.H, nblk), PASS, 0, s>>>(
      static_cast<float*>(ds), static_cast<const float*>(states),
      static_cast<const float*>(l_last), static_cast<float*>(dll), d.H, d.NC, PN,
      nblk * (PASS / 32));
  ssd_bwd_dx_kernel<T><<<dim3(B * d.NC, d.H, d.Q / d.bt), NT, DxLayout(d.P, d.N, d.bt).total, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(l),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(ds),
      static_cast<const float*>(D), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dbh), static_cast<float*>(ddt), static_cast<float*>(dlc),
      static_cast<float*>(kk), d);
  ssd_bwd_dc_kernel<T><<<dim3(B * d.NC, d.H, d.Q / d.bt), NT, DcLayout(d.P, d.N, d.bt).total, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(l),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(states),
      static_cast<const T*>(dy), static_cast<float*>(dch), static_cast<float*>(dlr), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The forward: states [B, NC, H, P, N] f32 (each chunk's S_in on return),
// y [B, T, H, P]. dtype 1: bf16 x, B, C, y. dt, l, l_last
// ([B, NC, H]) and D are f32.
extern "C" int ssd_forward(int dtype, const void* x, const void* dt, const void* l,
                           const void* l_last, const void* Bm, const void* Cm, const void* D,
                           void* states, void* y, int B, int T, int H, int G, int P, int N,
                           int Q, void* stream) {
  if (!dims_ok(B, T, H, G, P, N, Q)) return cudaErrorInvalidValue;
  const Dims d{T, H, G, T / Q, Q, P, N, Q < 64 ? Q : 64};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return forward<__nv_bfloat16>(x, dt, l, l_last, Bm, Cm, D, states, y, B, d, s);
  return cudaErrorInvalidValue;
}

// The backward: ds [B, NC, H, P, N] and dll [B, NC, H, parts] f32 scratch
// (dS_out and the chunk ends' decay gradient per part on return), dx like
// x, dbh and dch [B, T, H, N] f32, ddt, dlc, kk and dlr [B, T, H] f32.
extern "C" int ssd_backward(int dtype, const void* x, const void* dt, const void* l,
                            const void* l_last, const void* Bm, const void* Cm, const void* D,
                            const void* states, const void* dy, void* ds, void* dll, void* dx,
                            void* dbh, void* ddt, void* dlc, void* kk, void* dch, void* dlr,
                            int B, int T, int H, int G, int P, int N, int Q, void* stream) {
  if (!dims_ok(B, T, H, G, P, N, Q)) return cudaErrorInvalidValue;
  const Dims d{T, H, G, T / Q, Q, P, N, Q < 64 ? Q : 64};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, dt, l, l_last, Bm, Cm, D, states, dy, ds, dll, dx, dbh,
                                   ddt, dlc, kk, dch, dlr, B, d, s);
  return cudaErrorInvalidValue;
}
