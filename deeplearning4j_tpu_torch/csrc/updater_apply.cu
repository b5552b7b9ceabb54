// The optimizer tail of a training step over every f32 leaf of a network,
// in two kernels instead of a dozen torch ops a leaf:
//   updater_apply   per element of every leaf, in one pass:
//                     g' = g + l2 * w                        (the L2 gradient)
//                     state, w <- the updater's step on (+-)g'
//                   and per block the partial sums of g'^2 (the gradient
//                   norm) and of 0.5 * l2 * w^2 over the old w (the L2 term)
//   updater_finish  one block: the partials summed in a fixed order into
//                   diag = [loss + L2 term, sqrt(sum g'^2)]
// The updaters are SGD, Nesterovs and RMSProp (train/updaters.py), each in
// the op order of its per-leaf torch version, every product, sum, square
// root and quotient rounded on its own (__fmul_rn, __fadd_rn, __fsqrt_rn,
// __fdiv_rn: no FMA contraction), so that the parameters and state equal
// the per-leaf path's bit for bit where autograd's L2 term rounds as g + l2*w.
//
// Replaces no TPU kernel: the JAX package leaves the updater to XLA, which
// fuses it. In eager PyTorch the per-leaf tail is a dozen small kernels a
// leaf (161 leaves in ResNet-50), each at its launch floor.
//
// What bounds it on an H100: bytes. Each element reads w, g and the state
// once and writes w and the state once: 20 bytes (12 for SGD), 510 MB for
// ResNet-50's 25.5 M parameters, 0.15 ms at 3.35 TB/s.
//
// Design: apex's multi-tensor apply. The wrapper (ops/fused_updater.py)
// cuts each leaf into chunks of CHUNK elements and packs the leaves'
// pointers, sizes, l2 and lr multipliers and a block -> (leaf, chunk) map
// into a Table passed by value as the kernel's parameter, as many launches
// as the table needs (at most MAX_LEAVES leaves and MAX_BLOCKS blocks
// each). Inside a captured CUDA graph the parameter, pointers included, is
// baked into the graph; lr is read from the device on every launch. A
// block streams its chunk in 16-byte units where the leaf's pointers are
// 16-byte aligned and its size a multiple of 4, element by element
// otherwise. Partial sums: f32 in a thread, f64 across the block in a
// fixed tree, one pair a block; the finish sums them in index order. No
// atomics: the same table gives the same bits.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 8192;
constexpr int MAX_LEAVES = 36;
constexpr int MAX_BLOCKS = 320;
constexpr int FINISH_THREADS = 512;

struct Table {
  float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  float* s[MAX_LEAVES];         // the updater's state (unused by SGD)
  long long n[MAX_LEAVES];      // elements
  float l2[MAX_LEAVES];         // f32(l2); 0: no L2 term
  float half_l2[MAX_LEAVES];    // f32(0.5 * l2), the score's coefficient
  float mult[MAX_LEAVES];       // f32 lr multiplier
  unsigned char leaf[MAX_BLOCKS];
  int chunk[MAX_BLOCKS];
};

// Each updater's constants as its torch version rounds them to f32.
struct Hyper {
  float a;  // Nesterovs: mu;      RMSProp: decay
  float b;  // Nesterovs: -mu;     RMSProp: 1 - decay
  float c;  // Nesterovs: 1 + mu;  RMSProp: epsilon
};

static_assert(sizeof(Table) + sizeof(Hyper) + 4 * sizeof(void*) + 2 * sizeof(int) <= 4096,
              "kernel parameters are limited to 4 KB");

enum { SGD = 0, NESTEROVS = 1, RMSPROP = 2 };

// One element's step on gradient g with learning rate lr; returns the new
// w and leaves the new state in s.
template <int KIND>
__device__ __forceinline__ float step(float w, float& s, float g, float lr, const Hyper& h) {
  if (KIND == SGD) {  // -lr * g
    return __fadd_rn(w, __fmul_rn(-lr, g));
  } else if (KIND == NESTEROVS) {  // v' = mu*v - lr*g;  -mu*v + (1+mu)*v'
    const float v = __fsub_rn(__fmul_rn(h.a, s), __fmul_rn(lr, g));
    const float u = __fadd_rn(__fmul_rn(h.b, s), __fmul_rn(h.c, v));
    s = v;
    return __fadd_rn(w, u);
  } else {  // r' = decay*r + (1-decay)*g*g;  -lr*g / (sqrt(r') + eps)
    const float r = __fadd_rn(__fmul_rn(h.a, s), __fmul_rn(__fmul_rn(h.b, g), g));
    const float u = __fdiv_rn(__fmul_rn(-lr, g), __fadd_rn(__fsqrt_rn(r), h.c));
    s = r;
    return __fadd_rn(w, u);
  }
}

template <int KIND>
__device__ __forceinline__ void element(float& w, float& s, float g, float l2, float lr,
                                        float sign, const Hyper& h, float& gsq, float& wsq) {
  if (l2 != 0.0f) {
    wsq = fmaf(w, w, wsq);
    g = __fadd_rn(g, __fmul_rn(l2, w));
  }
  gsq = fmaf(g, g, gsq);
  w = step<KIND>(w, s, __fmul_rn(sign, g), lr, h);
}

// Sum over the block, in a fixed order; the result in thread 0.
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = 0.0;
    for (int i = 0; i < (int)(blockDim.x / 32); ++i) v += red[i];
  }
  return v;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS) updater_apply_kernel(
    const Table t, const Hyper h, const float* __restrict__ lr_ptr, float sign,
    double* __restrict__ partials) {
  __shared__ double red[THREADS / 32];
  const int leaf = t.leaf[blockIdx.x];
  const long long n = t.n[leaf];
  const long long lo = (long long)t.chunk[blockIdx.x] * CHUNK;
  const long long hi = lo + CHUNK < n ? lo + CHUNK : n;
  float* __restrict__ p = t.p[leaf];
  const float* __restrict__ g = t.g[leaf];
  float* __restrict__ s = t.s[leaf];
  const float l2 = t.l2[leaf];
  const float lr = __fmul_rn(*lr_ptr, t.mult[leaf]);
  const bool has_state = KIND != SGD;
  const unsigned long long addr =
      (unsigned long long)p | (unsigned long long)g | (has_state ? (unsigned long long)s : 0ull);
  float gsq = 0.0f, wsq = 0.0f;
  if ((n & 3) == 0 && (addr & 15) == 0) {
    for (long long i = lo + 4 * threadIdx.x; i < hi; i += 4 * THREADS) {
      float4 w4 = *reinterpret_cast<const float4*>(p + i);
      const float4 g4 = *reinterpret_cast<const float4*>(g + i);
      float4 s4 = has_state ? *reinterpret_cast<const float4*>(s + i)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      element<KIND>(w4.x, s4.x, g4.x, l2, lr, sign, h, gsq, wsq);
      element<KIND>(w4.y, s4.y, g4.y, l2, lr, sign, h, gsq, wsq);
      element<KIND>(w4.z, s4.z, g4.z, l2, lr, sign, h, gsq, wsq);
      element<KIND>(w4.w, s4.w, g4.w, l2, lr, sign, h, gsq, wsq);
      *reinterpret_cast<float4*>(p + i) = w4;
      if (has_state) *reinterpret_cast<float4*>(s + i) = s4;
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
      float w = p[i], st = has_state ? s[i] : 0.0f;
      element<KIND>(w, st, g[i], l2, lr, sign, h, gsq, wsq);
      p[i] = w;
      if (has_state) s[i] = st;
    }
  }
  const double bg = block_sum((double)gsq, red);
  const double bw = block_sum((double)wsq, red);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = bg;
    partials[2 * blockIdx.x + 1] = (double)t.half_l2[leaf] * bw;
  }
}

__global__ void __launch_bounds__(FINISH_THREADS) updater_finish_kernel(
    const double* __restrict__ partials, int blocks, const float* __restrict__ loss,
    float* __restrict__ diag) {
  __shared__ double red[FINISH_THREADS / 32];
  double sg = 0.0, sw = 0.0;
  for (int b = threadIdx.x; b < blocks; b += FINISH_THREADS) {
    sg += partials[2 * b];
    sw += partials[2 * b + 1];
  }
  sg = block_sum(sg, red);
  sw = block_sum(sw, red);
  if (threadIdx.x == 0) {
    diag[0] = __fadd_rn(*loss, (float)sw);
    diag[1] = __fsqrt_rn((float)sg);
  }
}

}  // namespace

// The Table's size, for the wrapper's check of its own layout.
extern "C" int updater_table_bytes() { return (int)sizeof(Table); }

// One launch of `blocks` blocks over the table (blocks <= MAX_BLOCKS),
// writing the partials of its blocks at partials[2 * block]. kind: 0 SGD,
// 1 Nesterovs, 2 RMSProp; lr a device f32; sign -1 to maximize. Returns
// cudaGetLastError() after the launch.
extern "C" int updater_apply(int kind, const void* table, int blocks, float a, float b,
                             float c, const void* lr, float sign, void* partials,
                             void* stream) {
  if (blocks < 1 || blocks > MAX_BLOCKS) return cudaErrorInvalidValue;
  const Table& t = *static_cast<const Table*>(table);
  const Hyper h{a, b, c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lr_ptr = static_cast<const float*>(lr);
  double* part = static_cast<double*>(partials);
  if (kind == SGD)
    updater_apply_kernel<SGD><<<blocks, THREADS, 0, st>>>(t, h, lr_ptr, sign, part);
  else if (kind == NESTEROVS)
    updater_apply_kernel<NESTEROVS><<<blocks, THREADS, 0, st>>>(t, h, lr_ptr, sign, part);
  else if (kind == RMSPROP)
    updater_apply_kernel<RMSPROP><<<blocks, THREADS, 0, st>>>(t, h, lr_ptr, sign, part);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// diag[0] = loss + the L2 term, diag[1] = the gradient norm, from the
// partials of `blocks` blocks. loss and diag are device f32.
extern "C" int updater_finish(const void* partials, int blocks, const void* loss, void* diag,
                              void* stream) {
  if (blocks < 1) return cudaErrorInvalidValue;
  updater_finish_kernel<<<1, FINISH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partials), blocks, static_cast<const float*>(loss),
      static_cast<float*>(diag));
  return cudaGetLastError();
}
