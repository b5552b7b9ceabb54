// Peephole LSTM forward over a whole sequence, in one persistent launch:
// for t in 0..T-1, with h, c carried in f32,
//   pre = xg[t] + h @ RW; i,f,g,o and c', h' as in lstm_step.cu;
//   writes y[t] = h', acts[t] = [i|f|g|o], hprev[t] = h, cprev[t] = c;
// and cF = c after the last step. Same outputs as the TPU kernel, so the
// training slice only adds the backward.
//
// Replaces: deeplearning4j_tpu/ops/pallas_lstm.py `_fwd_call` ->
// `_fwd_kernel` (via `lstm_sequence` / `_lstm_fwd`), which keeps RW, h and
// c in VMEM across a sequential time grid.
//
// What bounds it on an H100: the serial chain of T dependent steps. Bytes
// are small (xg in, y/acts/hprev/cprev out, RW once: at H=200, B=32,
// T=100, f32 about 10 MB, 3 us at 3.35 TB/s) and so are the operations
// (2*T*B*H*4H = 0.5 GFLOP, 8 us at the f32 rate), but every step needs all
// of the previous step's h, so the time is T times the latency of one
// step plus one grid-wide exchange of h.
//
// Design: RW at H=200 is 640 KB in f32, more than one SM's 227 KB of
// shared memory, so no single block can hold it as the TPU kernel holds
// it in VMEM. One cooperative launch of ceil(H/U) co-resident blocks
// instead; a block owns U hidden units and keeps their four gate-column
// slices of RW ([H, 4U] f32, 25.6 KB at H=200) in shared memory for all T
// steps. A unit's cell state depends only on its own gates, so c never
// leaves its block: it lives in shared memory ([B, U] f32) for the whole
// sequence. Only h is exchanged, through a double-buffered f32 buffer in
// global memory (read with ld.global.cg, past the non-coherent L1) and a
// grid barrier per step: each block's writes, __threadfence(), one atomic
// arrive on a counter, then a spin until all blocks have arrived. Writing
// step t+1's h into the other buffer half means one barrier per step is
// enough. The per-unit dot product runs over k = 0..H-1 in a fixed order,
// as in lstm_step.cu. cudaLaunchCooperativeKernel refuses a grid whose
// blocks cannot all be resident at once, and the entry point checks the
// occupancy first, so the spin cannot deadlock.
#include "common.cuh"

namespace {

constexpr int U = 8;            // hidden units per block
constexpr int BB = 8;           // batch rows per pass over the h rows
constexpr int NC = 4 * U;       // gate columns per block
constexpr int NT = BB * NC;     // threads: one per (row, gate column)

template <typename T>
__global__ void __launch_bounds__(NT) lstm_sequence_kernel(
    const T* __restrict__ xg, const T* __restrict__ rw,
    const T* __restrict__ p_i, const T* __restrict__ p_f,
    const T* __restrict__ p_o, const T* __restrict__ h0,
    const T* __restrict__ c0, T* __restrict__ y, T* __restrict__ acts,
    T* __restrict__ hprev, T* __restrict__ cprev, T* __restrict__ c_final,
    float* hbuf, unsigned int* bar, int steps, int B, int H) {
  extern __shared__ float smem[];
  float* rw_s = smem;            // [H][NC]: rw_s[k][g*U+u] = RW[k][g*H+j0+u]
  float* h_s = rw_s + H * NC;    // [BB][H]: the rows of h_{t-1} in this pass
  float* c_s = h_s + BB * H;     // [B][U]: this block's cell state, f32
  __shared__ float pre_s[BB][NC];
  __shared__ float peep_s[3][U];

  const int j0 = blockIdx.x * U;
  const int tid = threadIdx.x;
  const int H4 = 4 * H;

  for (int idx = tid; idx < H * NC; idx += NT) {
    const int k = idx / NC, c = idx % NC;
    const int j = j0 + c % U;
    rw_s[idx] = j < H ? dl4j::to_f32(rw[(size_t)k * H4 + (c / U) * H + j]) : 0.0f;
  }
  if (tid < 3 * U) {
    const int j = j0 + tid % U;
    const T* p = tid < U ? p_i : (tid < 2 * U ? p_f : p_o);
    peep_s[tid / U][tid % U] = j < H ? dl4j::to_f32(p[j]) : 0.0f;
  }
  for (int idx = tid; idx < B * U; idx += NT) {
    const int j = j0 + idx % U;
    c_s[idx] = j < H ? dl4j::to_f32(c0[(size_t)(idx / U) * H + j]) : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const float* h_src = hbuf + (size_t)(t & 1) * B * H;
    float* h_dst = hbuf + (size_t)((t + 1) & 1) * B * H;
    for (int b0 = 0; b0 < B; b0 += BB) {
      for (int idx = tid; idx < BB * H; idx += NT) {
        const int b = b0 + idx / H;
        const size_t off = (size_t)b * H + idx % H;
        h_s[idx] = b >= B ? 0.0f : (t == 0 ? dl4j::to_f32(h0[off]) : __ldcg(h_src + off));
      }
      __syncthreads();
      {
        const int c = tid % NC, bl = tid / NC;
        const int j = j0 + c % U, b = b0 + bl;
        const float* hr = h_s + bl * H;
        float acc = 0.0f;
        for (int k = 0; k < H; ++k) acc = fmaf(hr[k], rw_s[k * NC + c], acc);
        if (b < B && j < H)
          acc += dl4j::to_f32(xg[((size_t)t * B + b) * H4 + (c / U) * H + j]);
        pre_s[bl][c] = acc;
      }
      __syncthreads();
      if (tid < BB * U) {
        const int bl = tid / U, u = tid % U;
        const int j = j0 + u, b = b0 + bl;
        if (b < B && j < H) {
          const float c = c_s[b * U + u];
          const float ig = dl4j::sigmoid(pre_s[bl][u] + c * peep_s[0][u]);
          const float fg = dl4j::sigmoid(pre_s[bl][U + u] + c * peep_s[1][u]);
          const float gg = tanhf(pre_s[bl][2 * U + u]);
          const float cn = fg * c + ig * gg;
          const float og = dl4j::sigmoid(pre_s[bl][3 * U + u] + cn * peep_s[2][u]);
          const float hn = og * tanhf(cn);
          const size_t off = ((size_t)t * B + b) * H + j;
          const size_t aoff = ((size_t)t * B + b) * H4 + j;
          hprev[off] = dl4j::from_f32<T>(h_s[bl * H + j]);
          cprev[off] = dl4j::from_f32<T>(c);
          acts[aoff] = dl4j::from_f32<T>(ig);
          acts[aoff + H] = dl4j::from_f32<T>(fg);
          acts[aoff + 2 * H] = dl4j::from_f32<T>(gg);
          acts[aoff + 3 * H] = dl4j::from_f32<T>(og);
          y[off] = dl4j::from_f32<T>(hn);
          h_dst[(size_t)b * H + j] = hn;
          c_s[b * U + u] = cn;
          if (t == steps - 1) c_final[(size_t)b * H + j] = dl4j::from_f32<T>(cn);
        }
      }
      __syncthreads();
    }
    if (t + 1 < steps) dl4j::grid_barrier(bar, (unsigned int)(t + 1) * gridDim.x);
  }
}

template <typename T>
int launch(const void* xg, const void* rw, const void* p_i, const void* p_f,
           const void* p_o, const void* h0, const void* c0, void* y,
           void* acts, void* hprev, void* cprev, void* c_final, void* hbuf,
           void* bar, int steps, int B, int H, cudaStream_t stream) {
  auto kern = lstm_sequence_kernel<T>;
  const size_t smem = (size_t)(H * NC + BB * H + B * U) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (H + U - 1) / U;
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&xg, &rw, &p_i, &p_f, &p_o, &h0, &c0, &y, &acts,
                  &hprev, &cprev, &c_final, &hbuf, &bar, &steps, &B, &H};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(blocks),
                                  dim3(NT), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. hbuf: [2, B, H] f32 scratch; bar: one zeroed
// uint32. Returns the launch's error code (0 = launched).
extern "C" int lstm_sequence_forward(
    int dtype, const void* xg, const void* rw, const void* p_i,
    const void* p_f, const void* p_o, const void* h0, const void* c0,
    void* y, void* acts, void* hprev, void* cprev, void* c_final, void* hbuf,
    void* bar, int steps, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xg, rw, p_i, p_f, p_o, h0, c0, y, acts, hprev, cprev,
                         c_final, hbuf, bar, steps, B, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xg, rw, p_i, p_f, p_o, h0, c0, y, acts, hprev,
                                 cprev, c_final, hbuf, bar, steps, B, H, s);
  return cudaErrorInvalidValue;
}
