// One inference-only LSTM decode step, peepholes optional:
//   pre = xg + h0 @ RW                      ([B,4H], gate blocks [i|f|g|o])
//   i = sig(pre_i + c0*pI)   f = sig(pre_f + c0*pF)   g = tanh(pre_g)
//   c1 = f*c0 + i*g          o = sig(pre_o + c1*pO)   h1 = o*tanh(c1)
//
// Replaces: deeplearning4j_tpu/ops/pallas_lstm.py `lstm_step` ->
// `_step_kernel` (the decode serving engine's per-token step).
//
// What bounds it on an H100: latency. At the decode engine's shape (H=200,
// B=8, f32) the step reads 694 KB, almost all of it RW (640 KB, 0.2 us at
// 3.35 TB/s, and after the first step RW sits in the 50 MB L2), and does
// 2*B*H*4H = 2.6 MFLOP, a few hundredths of a microsecond at the f32 rate.
// What a call costs is the latencies it pays in series: the launch, the
// round trip that stages RW, a barrier, the product, a barrier, the gate
// math and the stores. The design shortens each of them:
//
// - It fills the card. A block owns U hidden units and all four of their
//   gate columns j, H+j, 2H+j, 3H+j, so the gate math stays in the block:
//   ceil(H/U) x ceil(B/BB) blocks, 50 at H=200, B=8, U=4 (the design it
//   replaces used 25 of the 132 SMs).
// - It stages RW with cp.async copies that need no thread's attention: at
//   U=4 in f32 each gate's strip of a row of the slice is one 16-byte copy
//   (8 and 4 bytes at U=2 and in bf16; two 16-byte copies at U=8 in f32).
//   RW lands in its own dtype and is converted where it is used. Where
//   H % U != 0 or RW is not 16-byte aligned, plain loads stage it, LOADS in
//   flight a thread before their stores. h lands in f32: by 4-byte
//   cp.async in f32, by plain loads in bf16.
// - It overlaps the prologue with the kernel before it (programmatic
//   dependent launch, STEP_PDL): the RW copies are issued first, then
//   `griddepcontrol.wait`, and only after it are h0, c0, xg and the
//   peepholes read, which the kernels before may have written. So RW must
//   be complete before the call's immediate predecessor in the stream
//   starts (the LSTM layer casts it before the input projection). The gate
//   threads load xg, c0 and the peepholes into registers there, and use
//   them after the product.
// - It splits k and blocks the product in registers. A thread owns one
//   chunk of ceil(H/S) consecutive k (rounded up to a multiple of 4), one
//   row and CT = 2 gate columns: per 4 k it makes one 16-byte load of h and
//   4 8-byte loads of RW for 8 FMAs (a thread per column, loading h and RW
//   for each FMA, was held by shared memory's load rate). It sums in k
//   order into ACC = 2 accumulators a column (k goes to accumulator
//   (k - chunk start) % 2), added as a0 + a1. The S partials meet in
//   shared memory and are added in the order s = 0..S-1. Chunk bounds and
//   the order depend only on H: a row's sum does not depend on B, on the
//   row's slot index or on the grid, which is what lets the decode engine
//   (B = n_slots) reproduce a B = 1 per-request `rnn_time_step` loop bit
//   for bit.
// - The gate math reads the partials straight from shared memory: one
//   barrier after staging, one after the product, nothing more.
//
// Compile-time knobs, swept by chip_smoke.py (STEP_SWEEP) through the same
// C entry of a library built with -D defines: STEP_U (units a block),
// STEP_S (k chunks), STEP_PDL (programmatic dependent launch on/off). The
// shipped build is U=4, S=4, PDL on. A variant with another S sums in
// another order, so each is held against the plain version, not bit-equal
// to the shipped build.
#include <cstdint>

#include "common.cuh"

#ifndef STEP_U
#define STEP_U 4
#endif
#ifndef STEP_S
#define STEP_S 4
#endif
#ifndef STEP_PDL
#define STEP_PDL 1
#endif

namespace {

constexpr int U = STEP_U;       // hidden units a block
constexpr int S = STEP_S;       // k chunks a (row, gate column)
constexpr int BB = 8;           // batch rows a block
constexpr int NC = 4 * U;       // gate columns a block
constexpr int CT = 2;           // gate columns a thread
constexpr int NT = NC / CT * BB * S;  // threads: one per (chunk, row, column pair)
constexpr int ACC = 2;          // independent accumulators a column
constexpr int LOADS = 8;        // staging loads in flight a thread
static_assert(U % 2 == 0, "a column pair never straddles two gates");
static_assert(NT <= 1024 && NT % 32 == 0, "a block is whole warps, at most 1024 threads");
static_assert(BB * U <= NT, "one gate thread a (row, unit)");
static_assert(ACC == 2, "the product adds its two accumulators as a0 + a1");

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
// h rows in shared memory: a multiple of 4 floats (16-byte loads of 4 k)
// and an odd number of 16-byte units, so the rows a warp reads at one k
// fall in distinct banks
__host__ __device__ inline int h_stride(int H) {
  const int hp = (H + 3) / 4 * 4;
  return (hp / 4) % 2 ? hp : hp + 4;
}
// k chunk length: ceil(H / S) rounded up to a multiple of 4, so every
// chunk starts 16-byte aligned in a row of h
__host__ __device__ inline int chunk(int H) { return ((H + S - 1) / S + 3) / 4 * 4; }

template <typename T>
size_t smem_bytes(int H) {
  return align16((size_t)H * NC * sizeof(T)) + (size_t)BB * h_stride(H) * 4 +
         (size_t)S * BB * NC * 4;
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N)
                 : "memory");
  }
}

// A thread's CT columns of one row of the RW slice, as one vector load,
// converted to f32.
template <typename T>
struct alignas(CT * sizeof(T)) Cols {
  T v[CT];
};
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&w)[CT]) {
  const Cols<T> c = *reinterpret_cast<const Cols<T>*>(p);
#pragma unroll
  for (int i = 0; i < CT; ++i) w[i] = dl4j::to_f32(c.v[i]);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT) lstm_step_kernel(
    const T* __restrict__ xg, const T* __restrict__ rw,
    const T* __restrict__ p_i, const T* __restrict__ p_f,
    const T* __restrict__ p_o, const T* __restrict__ h0,
    const T* __restrict__ c0, T* __restrict__ h1, T* __restrict__ c1,
    int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  // rw_s[k][g*U + u] = RW[k][g*H + j0 + u], in RW's dtype
  T* rw_s = reinterpret_cast<T*>(smem);
  const int hp = h_stride(H);
  float* h_s = reinterpret_cast<float*>(smem + align16((size_t)H * NC * sizeof(T)));  // [BB][hp]
  float* part_s = h_s + BB * hp;                                                      // [S][BB][NC]

  const int j0 = blockIdx.x * U;
  const int b0 = blockIdx.y * BB;
  const int tid = threadIdx.x;
  const int H4 = 4 * H;

  // 1. RW slice -> shared memory: depends on no kernel before this one
  if constexpr (VEC) {  // H % U == 0: every block owns U units
    constexpr int STRIP = U * (int)sizeof(T);
    constexpr int CB = STRIP < 16 ? STRIP : 16;
    constexpr int PER = STRIP / CB;  // copies a strip
    for (int idx = tid; idx < H * 4 * PER; idx += NT) {
      const int k = idx / (4 * PER), r = idx % (4 * PER), g = r / PER, p = r % PER;
      cp_async<CB>(reinterpret_cast<unsigned char*>(rw_s + k * NC + g * U) + p * CB,
                   reinterpret_cast<const unsigned char*>(rw + (size_t)k * H4 + g * H + j0) +
                       p * CB);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {  // LOADS loads in flight a thread before their stores
    for (int base = tid; base < H * NC; base += NT * LOADS) {
      T v[LOADS];
#pragma unroll
      for (int r = 0; r < LOADS; ++r) {
        const int idx = base + r * NT, k = idx / NC, c = idx % NC, u = c % U;
        v[r] = idx < H * NC && j0 + u < H ? rw[(size_t)k * H4 + (c / U) * H + j0 + u]
                                          : dl4j::from_f32<T>(0.0f);
      }
#pragma unroll
      for (int r = 0; r < LOADS; ++r)
        if (base + r * NT < H * NC) rw_s[base + r * NT] = v[r];
    }
  }

  // 2. the kernels before wrote xg, h0 and c0
#if STEP_PDL
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#endif
  const int nb = min(BB, B - b0);  // rows this block owns
  // the gate threads' operands, loaded now and used after the product
  const int gb = tid / U, gu = tid % U;
  const bool gate = tid < BB * U && gb < nb && j0 + gu < H;
  float xr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cr = 0.0f, pi = 0.0f, pf = 0.0f, po = 0.0f;
  if (gate) {
    const int j = j0 + gu;
    const T* x = xg + (size_t)(b0 + gb) * H4 + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) xr[g] = dl4j::to_f32(x[g * H]);
    cr = dl4j::to_f32(c0[(size_t)(b0 + gb) * H + j]);
    pi = dl4j::to_f32(p_i[j]);
    pf = dl4j::to_f32(p_f[j]);
    po = dl4j::to_f32(p_o[j]);
  }
  // the block's h rows are nb * H consecutive values of h0: in f32 one
  // 4-byte cp.async each, in bf16 LOADS loads in flight a thread before
  // their stores
  const int nh = nb * H;
  const T* hsrc = h0 + (size_t)b0 * H;
  if constexpr (sizeof(T) == 4) {
    for (int idx = tid; idx < nh; idx += NT) cp_async<4>(h_s + (idx / H) * hp + idx % H, hsrc + idx);
  } else {
    for (int base = tid; base < nh; base += NT * LOADS) {
      float v[LOADS];
#pragma unroll
      for (int r = 0; r < LOADS; ++r)
        v[r] = base + r * NT < nh ? dl4j::to_f32(hsrc[base + r * NT]) : 0.0f;
#pragma unroll
      for (int r = 0; r < LOADS; ++r) {
        const int idx = base + r * NT;
        if (idx < nh) h_s[(idx / H) * hp + idx % H] = v[r];
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 3. one chunk of k of one row and CT columns per thread: per 4 k, one
  // 16-byte load of h and 4 vector loads of RW feed 4 CT FMAs; k goes to
  // accumulator (k - chunk start) % ACC
  {
    const int cp = tid % (NC / CT), bl = (tid / (NC / CT)) % BB, s = tid / (NC / CT * BB);
    if (bl < nb) {
      const int kc = chunk(H);
      const int k0 = s * kc, k1 = min(H, k0 + kc);
      const float* hr = h_s + bl * hp;
      const T* wr = rw_s + cp * CT;
      float a[ACC][CT];
#pragma unroll
      for (int i = 0; i < ACC; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) a[i][c] = 0.0f;
      float w[CT];
      int k = k0;
      for (; k + 4 <= k1; k += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hr + k);
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          load_cols(wr + (k + i) * NC, w);
#pragma unroll
          for (int c = 0; c < CT; ++c) a[i % ACC][c] = fmaf(hk[i], w[c], a[i % ACC][c]);
        }
      }
      for (int i = 0; k < k1; ++k, ++i) {  // the chunk's last 1-3 k (i even first)
        load_cols(wr + k * NC, w);
#pragma unroll
        for (int c = 0; c < CT; ++c) a[i % ACC][c] = fmaf(hr[k], w[c], a[i % ACC][c]);
      }
      float* out = part_s + (s * BB + bl) * NC + cp * CT;
#pragma unroll
      for (int c = 0; c < CT; ++c) out[c] = a[0][c] + a[1][c];
    }
  }
  __syncthreads();

  // 4. gate math on the partials, added in the order s = 0..S-1
  if (gate) {
    float pre[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float* p = part_s + gb * NC + g * U + gu;
      float v = p[0];
#pragma unroll
      for (int s = 1; s < S; ++s) v += p[s * BB * NC];
      pre[g] = v + xr[g];
    }
    const float ig = dl4j::sigmoid(pre[0] + cr * pi);
    const float fg = dl4j::sigmoid(pre[1] + cr * pf);
    const float gg = tanhf(pre[2]);
    const float cn = fg * cr + ig * gg;
    const float og = dl4j::sigmoid(pre[3] + cn * po);
    const size_t o = (size_t)(b0 + gb) * H + j0 + gu;
    h1[o] = dl4j::from_f32<T>(og * tanhf(cn));
    c1[o] = dl4j::from_f32<T>(cn);
  }
}

template <typename T, bool VEC>
int launch_kernel(const void* xg, const void* rw, const void* p_i, const void* p_f,
                  const void* p_o, const void* h0, const void* c0, void* h1, void* c1,
                  int B, int H, cudaStream_t stream) {
  auto kern = lstm_step_kernel<T, VEC>;
  const size_t smem = smem_bytes<T>(H);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((H + U - 1) / U, (B + BB - 1) / BB);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = STEP_PDL ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(xg), static_cast<const T*>(rw),
      static_cast<const T*>(p_i), static_cast<const T*>(p_f),
      static_cast<const T*>(p_o), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<T*>(h1), static_cast<T*>(c1), B, H);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int launch(const void* xg, const void* rw, const void* p_i, const void* p_f,
           const void* p_o, const void* h0, const void* c0, void* h1, void* c1,
           int B, int H, cudaStream_t stream) {
  if (B < 1 || H < 1) return cudaErrorInvalidValue;
  if (H % U == 0 && reinterpret_cast<uintptr_t>(rw) % 16 == 0)
    return launch_kernel<T, true>(xg, rw, p_i, p_f, p_o, h0, c0, h1, c1, B, H, stream);
  return launch_kernel<T, false>(xg, rw, p_i, p_f, p_o, h0, c0, h1, c1, B, H, stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int lstm_step(int dtype, const void* xg, const void* rw,
                         const void* p_i, const void* p_f, const void* p_o,
                         const void* h0, const void* c0, void* h1, void* c1,
                         int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xg, rw, p_i, p_f, p_o, h0, c0, h1, c1, B, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xg, rw, p_i, p_f, p_o, h0, c0, h1, c1, B, H, s);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) one block uses at hidden size H, and
// this build's knobs: what fused_lstm.step_smem and STEP_UNITS/STEP_SPLIT
// must agree with.
extern "C" long long lstm_step_smem(int dtype, int H) {
  return (long long)(dtype == 1 ? smem_bytes<__nv_bfloat16>(H) : smem_bytes<float>(H));
}
extern "C" int lstm_step_geometry(int* units, int* split, int* rows, int* pdl) {
  *units = U;
  *split = S;
  *rows = BB;
  *pdl = STEP_PDL;
  return 0;
}
