// Peephole LSTM backward over a whole sequence, in one persistent launch:
// for t = T-1 down to 0, with the dh and dc carries in f32,
//   dh = dh_carry + dy[t];  c_t = f*cprev + i*g (recomputed from the stashes);
//   the gate pre-activation grads dpre = [di|df|dg|do] with the
//   output-peephole term in dc; dxg[t] = dpre;
//   dRW += hprev[t]^T . dpre and dp{I,F,O} += sum_b ..., in f32 from the f32
//   dpre; dh_carry = dpre . RW^T; dc_carry = dc*f + dpre_i*pI + dpre_f*pF;
// and at the end dh0 = dh_carry, dc0 = dc_carry. It reads the stashes that
// lstm_sequence.cu writes (acts, hprev, cprev).
//
// Replaces: deeplearning4j_tpu/ops/pallas_lstm.py `_bwd_call` ->
// `_bwd_kernel` (via `_lstm_bwd`), which walks a reversed time grid with
// dh, dc, dRW and the peephole sums in VMEM scratch.
//
// What bounds it on an H100: the serial chain of T dependent steps, as in
// the forward. Bytes are small (acts, hprev, cprev, dy in, dxg out, RW and
// dRW once: at H=200, B=32, T=50, f32 about 15 MB, 4 us at 3.35 TB/s) and
// so are the operations (dRW and dh_carry, 4*T*B*H*4H = 1.02 GFLOP, 15 us
// at the f32 rate), but step t needs every unit's dpre of step t+1, so the
// time is T times the latency of one step plus one grid-wide exchange.
//
// Design: the same cooperative grid as the forward, ceil(H/U) co-resident
// blocks, block b owning hidden units j0..j0+U-1. What never leaves a
// block: its units' dc carry ([B, U] f32), their peephole sums (one
// register each), their column slice of dRW ([H, 4U] f32, 25.6 KB at
// H=200), accumulated from the block's own f32 dpre and hprev[t] read from
// global memory, and its units' rows of RW ([U, 4H] f32, 25.6 KB), which is
// what dh_carry[:, own] = dpre . RW[own, :]^T needs. Only dpre crosses
// blocks: each block writes its 4U f32 columns into a double-buffered
// [2, B, 4H] buffer, one grid barrier (common.cuh), and every block reads
// the whole row back with ld.global.cg. Every sum runs in a fixed order
// (dh_carry: one partial per gate over k ascending, added in gate order;
// dRW and the peephole sums: t descending, then b ascending), so the
// result depends on neither B's split into passes nor the grid.
#include "common.cuh"

namespace {

constexpr int U = 8;            // hidden units per block
constexpr int BB = 8;           // batch rows per pass
constexpr int NC = 4 * U;       // gate columns per block
constexpr int NT = BB * NC;     // threads: one per (row, gate, unit)

// part_s[bl][g][u] = sum over k < H, ascending, of dsrc_s[bl][g*H + k] *
// rw_s[u][g*H + k]: thread tid = (bl*4 + g)*U + u does one. rw_s rows are
// padded to 4H+1 floats, so the 32 lanes of a warp (one bl) hit distinct
// banks at H=200.
__device__ __forceinline__ void gate_partials(const float* dsrc_s, const float* rw_s,
                                              float* part_s, int H, int rws) {
  const int tid = threadIdx.x;
  const int bl = tid / NC, g = (tid % NC) / U, u = tid % U;
  const float* d = dsrc_s + (size_t)bl * 4 * H + g * H;
  const float* r = rw_s + (size_t)u * rws + g * H;
  float acc = 0.0f;
  for (int k = 0; k < H; ++k) acc = fmaf(d[k], r[k], acc);
  part_s[tid] = acc;
}

__device__ __forceinline__ float carry_sum(const float* part_s, int bl, int u) {
  const float* p = part_s + bl * NC + u;
  return ((p[0] + p[U]) + p[2 * U]) + p[3 * U];
}

// Rows b0..b0+BB-1 of a [B, 4H] f32 exchange buffer into dsrc_s (zeros
// past B), through L2: other blocks wrote them.
__device__ __forceinline__ void load_rows(float* dsrc_s, const float* src, int b0,
                                          int B, int H4) {
  for (int idx = threadIdx.x; idx < BB * H4; idx += NT) {
    const int bl = idx / H4;
    dsrc_s[idx] = b0 + bl < B ? __ldcg(src + (size_t)(b0 + bl) * H4 + idx % H4) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) lstm_sequence_bwd_kernel(
    const T* __restrict__ acts, const T* __restrict__ hprev,
    const T* __restrict__ cprev, const T* __restrict__ rw,
    const T* __restrict__ p_i, const T* __restrict__ p_f,
    const T* __restrict__ p_o, const T* __restrict__ dy,
    const T* __restrict__ dc_final, T* __restrict__ dxg,
    float* __restrict__ drw, float* __restrict__ dp_i, float* __restrict__ dp_f,
    float* __restrict__ dp_o, T* __restrict__ dh0, T* __restrict__ dc0,
    float* xbuf, unsigned int* bar, int steps, int B, int H) {
  extern __shared__ float smem[];
  const int H4 = 4 * H, rws = H4 + 1;
  float* rw_s = smem;                    // [U][4H+1]: rw_s[u][n] = RW[j0+u][n]
  float* drw_s = rw_s + U * rws;         // [H][NC]: drw_s[k][g*U+u] = dRW[k][g*H+j0+u]
  float* dsrc_s = drw_s + H * NC;        // [BB][4H]: the pass's rows of dpre_{t+1}
  float* hp_s = dsrc_s + BB * H4;        // [BB][H]: the pass's rows of hprev[t]
  float* dc_s = hp_s + BB * H;           // [B][U]: this block's dc carry
  __shared__ float part_s[BB * NC];      // per-gate partial sums of dh_carry
  __shared__ float dpre_s[BB][NC];       // this block's dpre columns, this pass
  __shared__ float pp_s[BB][3][U];       // peephole-gradient terms, this pass
  __shared__ float peep_s[3][U];

  const int j0 = blockIdx.x * U;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < U * H4; idx += NT) {
    const int u = idx / H4, n = idx % H4;
    rw_s[u * rws + n] = j0 + u < H ? dl4j::to_f32(rw[(size_t)(j0 + u) * H4 + n]) : 0.0f;
  }
  for (int idx = tid; idx < H * NC; idx += NT) drw_s[idx] = 0.0f;
  if (tid < 3 * U) {
    const int j = j0 + tid % U;
    const T* p = tid < U ? p_i : (tid < 2 * U ? p_f : p_o);
    peep_s[tid / U][tid % U] = j < H ? dl4j::to_f32(p[j]) : 0.0f;
  }
  for (int idx = tid; idx < B * U; idx += NT) {
    const int j = j0 + idx % U;
    dc_s[idx] = j < H ? dl4j::to_f32(dc_final[(size_t)(idx / U) * H + j]) : 0.0f;
  }
  float dp_acc = 0.0f;  // thread tid < 3U: peephole sum (tid / U) of unit tid % U
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int t = steps - 1 - s;
    const float* src = xbuf + (size_t)((s + 1) & 1) * B * H4;  // dpre_{t+1}
    float* dst = xbuf + (size_t)(s & 1) * B * H4;
    for (int b0 = 0; b0 < B; b0 += BB) {
      const int nb = min(BB, B - b0);
      if (s > 0) load_rows(dsrc_s, src, b0, B, H4);
      for (int idx = tid; idx < BB * H; idx += NT) {
        const int bl = idx / H;
        hp_s[idx] = bl < nb
            ? dl4j::to_f32(hprev[((size_t)t * B + b0 + bl) * H + idx % H]) : 0.0f;
      }
      __syncthreads();
      if (s > 0) gate_partials(dsrc_s, rw_s, part_s, H, rws);
      __syncthreads();
      if (tid < BB * U) {
        const int bl = tid / U, u = tid % U;
        const int j = j0 + u, b = b0 + bl;
        float d_i = 0.0f, d_f = 0.0f, d_g = 0.0f, d_o = 0.0f;
        float q_i = 0.0f, q_f = 0.0f, q_o = 0.0f;
        if (bl < nb && j < H) {
          const size_t off = ((size_t)t * B + b) * H + j;
          const size_t aoff = ((size_t)t * B + b) * H4 + j;
          const float ig = dl4j::to_f32(acts[aoff]);
          const float fg = dl4j::to_f32(acts[aoff + H]);
          const float gg = dl4j::to_f32(acts[aoff + 2 * H]);
          const float og = dl4j::to_f32(acts[aoff + 3 * H]);
          const float cp = dl4j::to_f32(cprev[off]);
          const float dh = (s > 0 ? carry_sum(part_s, bl, u) : 0.0f) + dl4j::to_f32(dy[off]);
          const float ct = fg * cp + ig * gg;
          const float tc = tanhf(ct);
          d_o = dh * tc * og * (1.0f - og);
          const float dc = dh * og * (1.0f - tc * tc) + dc_s[b * U + u] + d_o * peep_s[2][u];
          d_i = dc * gg * ig * (1.0f - ig);
          d_f = dc * cp * fg * (1.0f - fg);
          d_g = dc * ig * (1.0f - gg * gg);
          dxg[aoff] = dl4j::from_f32<T>(d_i);
          dxg[aoff + H] = dl4j::from_f32<T>(d_f);
          dxg[aoff + 2 * H] = dl4j::from_f32<T>(d_g);
          dxg[aoff + 3 * H] = dl4j::from_f32<T>(d_o);
          float* row = dst + (size_t)b * H4 + j;
          row[0] = d_i;
          row[H] = d_f;
          row[2 * H] = d_g;
          row[3 * H] = d_o;
          dc_s[b * U + u] = dc * fg + d_i * peep_s[0][u] + d_f * peep_s[1][u];
          q_i = d_i * cp;
          q_f = d_f * cp;
          q_o = d_o * ct;
        }
        dpre_s[bl][u] = d_i;
        dpre_s[bl][U + u] = d_f;
        dpre_s[bl][2 * U + u] = d_g;
        dpre_s[bl][3 * U + u] = d_o;
        pp_s[bl][0][u] = q_i;
        pp_s[bl][1][u] = q_f;
        pp_s[bl][2][u] = q_o;
      }
      __syncthreads();
      for (int idx = tid; idx < H * NC; idx += NT) {
        const int k = idx / NC, c = idx % NC;
        float acc = drw_s[idx];
        for (int bl = 0; bl < nb; ++bl) acc = fmaf(hp_s[bl * H + k], dpre_s[bl][c], acc);
        drw_s[idx] = acc;
      }
      if (tid < 3 * U)
        for (int bl = 0; bl < nb; ++bl) dp_acc += pp_s[bl][tid / U][tid % U];
      __syncthreads();
    }
    dl4j::grid_barrier(bar, (unsigned int)(s + 1) * gridDim.x);
  }

  // dh0 = dpre_0 . RW[own, :]^T; dc0 = the dc carry
  const float* src = xbuf + (size_t)((steps - 1) & 1) * B * H4;
  for (int b0 = 0; b0 < B; b0 += BB) {
    load_rows(dsrc_s, src, b0, B, H4);
    __syncthreads();
    gate_partials(dsrc_s, rw_s, part_s, H, rws);
    __syncthreads();
    if (tid < BB * U) {
      const int bl = tid / U, u = tid % U;
      const int j = j0 + u, b = b0 + bl;
      if (b < B && j < H) {
        dh0[(size_t)b * H + j] = dl4j::from_f32<T>(carry_sum(part_s, bl, u));
        dc0[(size_t)b * H + j] = dl4j::from_f32<T>(dc_s[b * U + u]);
      }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < H * NC; idx += NT) {
    const int k = idx / NC, c = idx % NC;
    const int j = j0 + c % U;
    if (j < H) drw[(size_t)k * H4 + (c / U) * H + j] = drw_s[idx];
  }
  if (tid < 3 * U && j0 + tid % U < H) {
    float* out = tid < U ? dp_i : (tid < 2 * U ? dp_f : dp_o);
    out[j0 + tid % U] = dp_acc;
  }
}

template <typename T>
int launch(const void* acts, const void* hprev, const void* cprev,
           const void* rw, const void* p_i, const void* p_f, const void* p_o,
           const void* dy, const void* dc_final, void* dxg, void* drw,
           void* dp_i, void* dp_f, void* dp_o, void* dh0, void* dc0,
           void* xbuf, void* bar, int steps, int B, int H, cudaStream_t stream) {
  auto kern = lstm_sequence_bwd_kernel<T>;
  const size_t smem =
      (size_t)(U * (4 * H + 1) + H * NC + BB * 4 * H + BB * H + B * U) * sizeof(float);
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
  void* args[] = {&acts, &hprev, &cprev, &rw, &p_i, &p_f, &p_o, &dy,
                  &dc_final, &dxg, &drw, &dp_i, &dp_f, &dp_o, &dh0, &dc0,
                  &xbuf, &bar, &steps, &B, &H};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(blocks),
                                  dim3(NT), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, for acts, hprev, cprev, rw, the peepholes, dy,
// dcF, dxg, dh0 and dc0; drw and dp_* are f32. xbuf: [2, B, 4H] f32
// scratch; bar: one zeroed uint32. Returns the launch's error code
// (0 = launched).
extern "C" int lstm_sequence_backward(
    int dtype, const void* acts, const void* hprev, const void* cprev,
    const void* rw, const void* p_i, const void* p_f, const void* p_o,
    const void* dy, const void* dc_final, void* dxg, void* drw, void* dp_i,
    void* dp_f, void* dp_o, void* dh0, void* dc0, void* xbuf, void* bar,
    int steps, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(acts, hprev, cprev, rw, p_i, p_f, p_o, dy, dc_final,
                         dxg, drw, dp_i, dp_f, dp_o, dh0, dc0, xbuf, bar,
                         steps, B, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(acts, hprev, cprev, rw, p_i, p_f, p_o, dy,
                                 dc_final, dxg, drw, dp_i, dp_f, dp_o, dh0,
                                 dc0, xbuf, bar, steps, B, H, s);
  return cudaErrorInvalidValue;
}
