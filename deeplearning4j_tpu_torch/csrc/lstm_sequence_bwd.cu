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
// Two variants, chosen in Python by `fused_lstm.lstm_variant`:
//
// "cluster" (H <= 256; the main path): the forward's clusters
// (lstm_cluster.cuh): C = 8 CTAs a cluster, R = 4 or 8 batch rows, CTA q
// owning units q*U..q*U+U-1 and the same [H, 4U] slice of RW, kept in
// shared memory transposed ([4U][H] f32, 80 KB at H=200). Per step,
// reversed:
//  1. thread r*U+u sums the C partials of its dh carry that the cluster
//     sent it (CTA order), adds dy, and does the gate math of row r, unit
//     u with its dc carry, its three peephole sums and the step's acts,
//     cprev and dy in registers; it writes its four dpre into the CTA's
//     [4U][R] buffer; one __syncthreads;
//  2. thread k (k < H) takes the CTA's partial of the next dh carry over
//     its own columns, dhp[r][k] = sum over c = g*U+u ascending of
//     dpre[r][c] * RW[k][g*H+j0+u] (R rows, R/4 broadcast float4 per c),
//     and stores it into the receive buffer of unit k's owner, slot of
//     this CTA ([2][C][R][U] f32): a reduce-scatter over DSMEM, a quarter
//     of the bytes of gathering the whole dpre row;
//  3. the cluster barrier, split: arrive (release); then dxg[t] (storage
//     dtype) and the f32 dpre[t] into a [T, B, 4H] scratch, and the loads
//     of step t-1's acts, cprev and dy into registers, none of which takes
//     part in the exchange, so the release does not wait for the stores
//     and the loads complete during the wait; wait (acquire).
// dRW = sum over (t, b) of hprev[t, b, :]^T . dpre[t, b, :] depends on
// nothing later in the chain, so it leaves it: after the loop a second
// kernel over the whole card computes it from the dpre scratch as an f32
// FMA product, [H, T*B] x [T*B, 4H], in 64 x 64 tiles, one partial per
// chunk of DRW_CHUNK rows of T*B (256, from the caller), and a third sums
// the partials in chunk order, and the peephole sums (each gate thread's
// sum over t, descending) over b ascending. No float atomics. Shared
// memory: 4*(4UH + 4UR + 2CRU) bytes: 86 KB at H=200 and R=4, 94 KB at
// R=8, 148 KB at H=256 and R=8, the variant's limit. Every sum runs in an
// order fixed by H and T*B alone, so R and the number of clusters change
// no bit, and two launches are bit-equal.
//
// "grid" (the cooperative-grid design, kept for H > 256 up to about H=550
// at B=32): ceil(H/U) co-resident blocks (U = 8), block b owning hidden
// units j0..j0+U-1. What never leaves a block: its units' dc carry ([B, U]
// f32), their peephole sums (one register each), their column slice of
// dRW ([H, 4U] f32), accumulated from the block's own f32 dpre and
// hprev[t] read from global memory, and its units' rows of RW ([U, 4H]
// f32), which is what dh_carry[:, own] = dpre . RW[own, :]^T needs. Only
// dpre crosses blocks: each block writes its 4U f32 columns into a
// double-buffered [2, B, 4H] buffer, one grid barrier (common.cuh), and
// every block reads the whole row back with ld.global.cg. Every sum runs
// in a fixed order (dh_carry: one partial per gate over k ascending, added
// in gate order; dRW and the peephole sums: t descending, then b
// ascending), so the result depends on neither B's split into passes nor
// the grid.
#include "common.cuh"
#include "lstm_cluster.cuh"

#include <algorithm>

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


// -- the cluster variant -------------------------------------------------------

namespace lc = dl4j::lstm_cluster;

template <typename T, int R>
__global__ void __launch_bounds__(lc::NT) lstm_sequence_bwd_cluster_kernel(
    const T* __restrict__ acts, const T* __restrict__ cprev,
    const T* __restrict__ rw, const T* __restrict__ p_i,
    const T* __restrict__ p_f, const T* __restrict__ p_o,
    const T* __restrict__ dy, const T* __restrict__ dc_final,
    T* __restrict__ dxg, float* __restrict__ dpre,
    float* __restrict__ dp_part, T* __restrict__ dh0, T* __restrict__ dc0,
    int steps, int B, int H) {
  constexpr int C = lc::C, NT = lc::NT, RV = R / 4;
  static_assert(R % 4 == 0, "a column's R rows of dpre are whole float4");
  extern __shared__ float4 smem4[];
  const int Uc = lc::units(H), NCc = 4 * Uc, H4 = 4 * H;
  float* rwt_s = reinterpret_cast<float*>(smem4);  // [4U][H]: rwt_s[g*U+u][k] = RW[k][g*H+j0+u]
  float* dp_s = rwt_s + NCc * H;                   // [4U][R]: this step's dpre, own columns
  float* recv = dp_s + NCc * R;                    // [2][C][R][U]: dh partials by sender

  const unsigned q = lc::rank();
  const int j0 = (int)q * Uc;
  const int nu = max(0, min(Uc, H - j0));
  const int b0 = blockIdx.y * R;
  const int nb = min(R, B - b0);
  const int tid = threadIdx.x;

  for (int idx = tid; idx < NCc * H; idx += NT) {
    const int c = idx / H, k = idx % H, u = c % Uc;
    rwt_s[idx] = u < nu ? dl4j::to_f32(rw[(size_t)k * H4 + (c / Uc) * H + j0 + u]) : 0.0f;
  }
  for (int idx = tid; idx < NCc * R; idx += NT) dp_s[idx] = 0.0f;

  const bool gate = tid < R * Uc;
  const int gr = gate ? tid / Uc : 0, gu = gate ? tid % Uc : 0;
  const bool gv = gate && gr < nb && gu < nu;
  const int gb = b0 + gr, gj = j0 + gu;
  float dc_carry = 0.0f, pi = 0.0f, pf = 0.0f, po = 0.0f;
  float s_i = 0.0f, s_f = 0.0f, s_o = 0.0f;  // peephole sums over t, descending
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cp = 0.0f, dyv = 0.0f;  // step t's inputs
  auto load_step = [&](int t) {
    const size_t off = ((size_t)t * B + gb) * H + gj;
    const T* ap = acts + ((size_t)t * B + gb) * H4 + gj;
#pragma unroll
    for (int g = 0; g < 4; ++g) a[g] = dl4j::to_f32(ap[g * H]);
    cp = dl4j::to_f32(cprev[off]);
    dyv = dl4j::to_f32(dy[off]);
  };
  if (gv) {
    dc_carry = dl4j::to_f32(dc_final[(size_t)gb * H + gj]);
    pi = dl4j::to_f32(p_i[gj]);
    pf = dl4j::to_f32(p_f[gj]);
    po = dl4j::to_f32(p_o[gj]);
    load_step(steps - 1);
  }
  lc::sync();

  for (int s = 0; s < steps; ++s) {
    const int t = steps - 1 - s;
    float d_i = 0.0f, d_f = 0.0f, d_g = 0.0f, d_o = 0.0f;
    if (gv) {
      float dh = 0.0f;
      if (s > 0) {
        const float* in = recv + (size_t)((s - 1) & 1) * C * R * Uc + gr * Uc + gu;
#pragma unroll
        for (int r = 0; r < C; ++r) dh += in[r * R * Uc];
      }
      dh += dyv;
      const float ig = a[0], fg = a[1], gg = a[2], og = a[3];
      const float ct = fg * cp + ig * gg;
      const float tc = tanhf(ct);
      d_o = dh * tc * og * (1.0f - og);
      const float dc = dh * og * (1.0f - tc * tc) + dc_carry + d_o * po;
      d_i = dc * gg * ig * (1.0f - ig);
      d_f = dc * cp * fg * (1.0f - fg);
      d_g = dc * ig * (1.0f - gg * gg);
      dp_s[gu * R + gr] = d_i;
      dp_s[(Uc + gu) * R + gr] = d_f;
      dp_s[(2 * Uc + gu) * R + gr] = d_g;
      dp_s[(3 * Uc + gu) * R + gr] = d_o;
      dc_carry = dc * fg + d_i * pi + d_f * pf;
      s_i += d_i * cp;
      s_f += d_f * cp;
      s_o += d_o * ct;
    }
    __syncthreads();
    if (tid < H) {
      // this CTA's partial of dh[r][k] over its own columns, to k's owner
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      const float4* d4 = reinterpret_cast<const float4*>(dp_s);
      const float* w = rwt_s + tid;
#pragma unroll 4
      for (int c = 0; c < NCc; ++c) {
        const float wc = w[c * H];
#pragma unroll
        for (int v = 0; v < RV; ++v) {
          const float4 x = d4[RV * c + v];
          acc[4 * v] = fmaf(x.x, wc, acc[4 * v]);
          acc[4 * v + 1] = fmaf(x.y, wc, acc[4 * v + 1]);
          acc[4 * v + 2] = fmaf(x.z, wc, acc[4 * v + 2]);
          acc[4 * v + 3] = fmaf(x.w, wc, acc[4 * v + 3]);
        }
      }
      const int owner = tid / Uc;
      const float* dst = recv + ((size_t)(s & 1) * C + q) * R * Uc + (tid - owner * Uc);
      const uint32_t base = lc::remote(dst, owner);
#pragma unroll
      for (int r = 0; r < R; ++r) lc::store_remote(base + r * Uc * sizeof(float), acc[r]);
    }
    lc::arrive();
    // the step's dxg and dpre, and step t-1's inputs, take no part in the
    // exchange: after the arrive, so the release does not wait for the
    // stores and the loads complete during the wait
    if (gv) {
      const size_t aoff = ((size_t)t * B + gb) * H4 + gj;
      dxg[aoff] = dl4j::from_f32<T>(d_i);
      dxg[aoff + H] = dl4j::from_f32<T>(d_f);
      dxg[aoff + 2 * H] = dl4j::from_f32<T>(d_g);
      dxg[aoff + 3 * H] = dl4j::from_f32<T>(d_o);
      dpre[aoff] = d_i;
      dpre[aoff + H] = d_f;
      dpre[aoff + 2 * H] = d_g;
      dpre[aoff + 3 * H] = d_o;
      if (s + 1 < steps) load_step(t - 1);
    }
    lc::wait();
  }

  if (gv) {
    const float* in = recv + (size_t)((steps - 1) & 1) * C * R * Uc + gr * Uc + gu;
    float dh = 0.0f;
#pragma unroll
    for (int r = 0; r < C; ++r) dh += in[r * R * Uc];
    dh0[(size_t)gb * H + gj] = dl4j::from_f32<T>(dh);
    dc0[(size_t)gb * H + gj] = dl4j::from_f32<T>(dc_carry);
    float* out = dp_part + (size_t)gb * 3 * H + gj;
    out[0] = s_i;
    out[H] = s_f;
    out[2 * H] = s_o;
  }
}

// dRW partials: part[z][k][n] = sum over m in chunk z (rows z*chunk ..
// z*chunk+chunk-1 of T*B, ascending) of hprev[m][k] * dpre[m][n]. A block
// computes a 64 x 64 tile of one chunk, DM rows at a time through shared
// memory, the next DM rows' loads in registers while this slab's products
// run; thread (ty, tx) a 4 x 4 piece. Rows past the chunk and columns past
// the edge load as zero.
constexpr int DT = 64, DM = 32, DE = DM * DT / 256;  // DE: elements a thread stages

template <typename T>
__global__ void __launch_bounds__(256) drw_partial_kernel(
    const T* __restrict__ hprev, const float* __restrict__ dpre,
    float* __restrict__ part, int M, int H, int chunk) {
  __shared__ float4 a_s[DM][DT / 4];  // hprev rows, 64 k columns
  __shared__ float4 b_s[DM][DT / 4];  // dpre rows, 64 n columns
  const int H4 = 4 * H;
  const int n0 = blockIdx.x * DT, k0 = blockIdx.y * DT, z = blockIdx.z;
  const int m0 = z * chunk, m1 = min(M, m0 + chunk);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float* af = reinterpret_cast<float*>(a_s);
  float* bf = reinterpret_cast<float*>(b_s);
  float ra[DE], rb[DE];
  auto fetch = [&](int mb) {
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      const int i = tid + 256 * e, m = mb + i / DT, cc = i % DT;
      ra[e] = m < m1 && k0 + cc < H ? dl4j::to_f32(hprev[(size_t)m * H + k0 + cc]) : 0.0f;
      rb[e] = m < m1 && n0 + cc < H4 ? dpre[(size_t)m * H4 + n0 + cc] : 0.0f;
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  fetch(m0);
  for (int mb = m0; mb < m1; mb += DM) {
#pragma unroll
    for (int e = 0; e < DE; ++e) {
      af[tid + 256 * e] = ra[e];
      bf[tid + 256 * e] = rb[e];
    }
    __syncthreads();
    if (mb + DM < m1) fetch(mb + DM);
#pragma unroll
    for (int mm = 0; mm < DM; ++mm) {
      const float4 av = a_s[mm][ty], bv = b_s[mm][tx];
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < H4) part[((size_t)z * H + k) * H4 + n] = acc[i][j];
    }
  }
}

// dRW = the partials summed in chunk order; dp{I,F,O}[j] = the peephole
// partials [B][3][H] summed over b ascending.
__global__ void __launch_bounds__(256) drw_reduce_kernel(
    const float* __restrict__ part, int chunks, float* __restrict__ drw,
    const float* __restrict__ dp_part, float* __restrict__ dp_i,
    float* __restrict__ dp_f, float* __restrict__ dp_o, int B, int H) {
  const size_t n = (size_t)H * 4 * H;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = part[e];
    for (int z = 1; z < chunks; ++z) s += part[(size_t)z * n + e];
    drw[e] = s;
    if (e < (size_t)3 * H) {
      float p = dp_part[e];
      for (int b = 1; b < B; ++b) p += dp_part[(size_t)b * 3 * H + e];
      float* out = e < (size_t)H ? dp_i : (e < (size_t)2 * H ? dp_f : dp_o);
      out[e % H] = p;
    }
  }
}

size_t cluster_smem(int H, int R) {
  const int Uc = lc::units(H);
  return (size_t)(4 * Uc * H + 4 * Uc * R + 2 * lc::C * R * Uc) * sizeof(float);
}

template <typename T, int R>
int launch_cluster(const void* acts, const void* hprev, const void* cprev,
                   const void* rw, const void* p_i, const void* p_f,
                   const void* p_o, const void* dy, const void* dc_final,
                   void* dxg, void* drw, void* dp_i, void* dp_f, void* dp_o,
                   void* dh0, void* dc0, void* dpre, void* drw_part,
                   void* dp_part, int steps, int B, int H, int chunk,
                   cudaStream_t stream) {
  if (lc::units(H) > lc::UMAX || chunk < 1) return cudaErrorInvalidValue;
  auto kern = lstm_sequence_bwd_cluster_kernel<T, R>;
  const size_t smem = cluster_smem(H, R);
  int max_clusters = 0;
  cudaError_t e = lc::prepare(kern, smem, &max_clusters);
  if (e != cudaSuccess) return e;
  lc::Config c((B + R - 1) / R, smem, stream);
  e = cudaLaunchKernelEx(&c.cfg, kern, static_cast<const T*>(acts),
                         static_cast<const T*>(cprev), static_cast<const T*>(rw),
                         static_cast<const T*>(p_i), static_cast<const T*>(p_f),
                         static_cast<const T*>(p_o), static_cast<const T*>(dy),
                         static_cast<const T*>(dc_final), static_cast<T*>(dxg),
                         static_cast<float*>(dpre), static_cast<float*>(dp_part),
                         static_cast<T*>(dh0), static_cast<T*>(dc0), steps, B, H);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int M = steps * B, chunks = (M + chunk - 1) / chunk;
  const dim3 grid((4 * H + DT - 1) / DT, (H + DT - 1) / DT, chunks);
  drw_partial_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(hprev), static_cast<const float*>(dpre),
      static_cast<float*>(drw_part), M, H, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t n = (size_t)H * 4 * H;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 1024);
  drw_reduce_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(drw_part), chunks, static_cast<float*>(drw),
      static_cast<const float*>(dp_part), static_cast<float*>(dp_i),
      static_cast<float*>(dp_f), static_cast<float*>(dp_o), B, H);
  return cudaGetLastError();
}

template <typename T>
int launch_rows(int rows, const void* acts, const void* hprev, const void* cprev,
                const void* rw, const void* p_i, const void* p_f, const void* p_o,
                const void* dy, const void* dc_final, void* dxg, void* drw, void* dp_i,
                void* dp_f, void* dp_o, void* dh0, void* dc0, void* dpre,
                void* drw_part, void* dp_part, int steps, int B, int H, int chunk,
                cudaStream_t s) {
  if (rows == 4)
    return launch_cluster<T, 4>(acts, hprev, cprev, rw, p_i, p_f, p_o, dy, dc_final, dxg,
                                drw, dp_i, dp_f, dp_o, dh0, dc0, dpre, drw_part, dp_part,
                                steps, B, H, chunk, s);
  if (rows == 8)
    return launch_cluster<T, 8>(acts, hprev, cprev, rw, p_i, p_f, p_o, dy, dc_final, dxg,
                                drw, dp_i, dp_f, dp_o, dh0, dc0, dpre, drw_part, dp_part,
                                steps, B, H, chunk, s);
  return cudaErrorInvalidValue;
}

template <typename T>
int occupancy(int H, int rows, int* max_clusters) {
  if (rows == 4)
    return lc::prepare(lstm_sequence_bwd_cluster_kernel<T, 4>, cluster_smem(H, 4),
                       max_clusters);
  if (rows == 8)
    return lc::prepare(lstm_sequence_bwd_cluster_kernel<T, 8>, cluster_smem(H, 8),
                       max_clusters);
  return cudaErrorInvalidValue;
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

// The cluster variant (H <= 256). dtype as above; rows: the batch rows of
// a cluster, 4 or 8. dpre: [T, B, 4H] f32 scratch; drw_part:
// [ceil(T*B/chunk), H, 4H] f32 scratch; dp_part: [B, 3, H] f32 scratch.
// Three launches on `stream`: the chain, the dRW partials, their sums.
// Returns the first error code (0 = launched).
extern "C" int lstm_sequence_backward_cluster(
    int dtype, const void* acts, const void* hprev, const void* cprev,
    const void* rw, const void* p_i, const void* p_f, const void* p_o,
    const void* dy, const void* dc_final, void* dxg, void* drw, void* dp_i,
    void* dp_f, void* dp_o, void* dh0, void* dc0, void* dpre, void* drw_part,
    void* dp_part, int steps, int B, int H, int chunk, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rows<float>(rows, acts, hprev, cprev, rw, p_i, p_f, p_o, dy, dc_final,
                              dxg, drw, dp_i, dp_f, dp_o, dh0, dc0, dpre, drw_part,
                              dp_part, steps, B, H, chunk, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(rows, acts, hprev, cprev, rw, p_i, p_f, p_o, dy,
                                      dc_final, dxg, drw, dp_i, dp_f, dp_o, dh0, dc0,
                                      dpre, drw_part, dp_part, steps, B, H, chunk, s);
  return cudaErrorInvalidValue;
}

// How many clusters of the backward cluster kernel (rows 4 or 8) the card
// holds at once (cudaOccupancyMaxActiveClusters) at hidden size H, into
// *max_clusters.
extern "C" int lstm_sequence_bwd_cluster_occupancy(int dtype, int H, int rows,
                                                   int* max_clusters) {
  if (lc::units(H) > lc::UMAX) return cudaErrorInvalidValue;
  if (dtype == 0) return occupancy<float>(H, rows, max_clusters);
  if (dtype == 1) return occupancy<__nv_bfloat16>(H, rows, max_clusters);
  return cudaErrorInvalidValue;
}
