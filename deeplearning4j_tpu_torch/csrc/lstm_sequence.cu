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
// Two variants, chosen in Python by `fused_lstm.lstm_variant`:
//
// "cluster" (H <= 256; the main path): the batch is cut across
// thread-block clusters of C = 8 CTAs, R rows each (R = 4 up to B = 64,
// else 8; lstm_cluster.cuh), so at B=32 eight clusters run side by side
// and no exchange ever crosses a cluster. CTA q owns units q*U..q*U+U-1
// (U = ceil(H/8), 25 at H=200) and keeps their four gate columns of RW
// ([H, 4U] f32, 80 KB at H=200) in shared memory for all T steps. Per
// step: warp w computes gate w%4 of the CTA's units for all R rows over
// one half of k (w/4), lane u one unit, R accumulators over k ascending
// (h_{t-1} read as R/4 broadcast float4 per k from a [H][R] buffer); one
// __syncthreads; thread r*U+u adds the two halves and xg and does the
// gate math of row r, unit u, keeping c in a register for the whole
// sequence, and writes its new h into the other half of the
// double-buffered [H][R] buffer; one __syncthreads; the CTA's block of
// new h (its U units, all R rows: contiguous) goes to every other CTA of
// the cluster in 16-byte st.shared::cluster stores (an all-gather over
// DSMEM); then the cluster barrier, split: arrive (release); the step's
// outputs to global memory and the loads of step t+1's xg into
// registers, which take no part in the exchange, so the release does not
// wait for the stores and the loads complete during the wait; wait
// (acquire). One cluster barrier and two __syncthreads per step; nothing
// goes through global memory but the inputs and outputs. Shared memory:
// 4*(4UH + 2RH + 8UR) bytes: 88 KB at H=200 and R=4, 97 KB at R=8, 152 KB
// at H=256 and R=8, the variant's limit (U <= 32: one lane a unit). The
// sums run in an order fixed by H (each half over k ascending, then the
// halves, then xg), so R and the number of clusters change no bit.
//
// "grid" (the cooperative-grid design, kept for H > 256 up to the
// shared-memory limit, about H=1400 at B=32): one cooperative launch of
// ceil(H/U) co-resident blocks (U = 8); a block owns U hidden units and
// keeps their four gate-column slices of RW ([H, 4U] f32) in shared
// memory for all T steps, c in shared memory ([B, U] f32). h is exchanged
// through a double-buffered f32 buffer in global memory (read with
// ld.global.cg, past the non-coherent L1) and a grid barrier per step
// (common.cuh). cudaLaunchCooperativeKernel refuses a grid whose blocks
// cannot all be resident at once, and the entry point checks the
// occupancy first, so the spin cannot deadlock.
#include "common.cuh"
#include "lstm_cluster.cuh"

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


// -- the cluster variant -------------------------------------------------------

namespace lc = dl4j::lstm_cluster;

template <typename T, int R>
__global__ void __launch_bounds__(lc::NT) lstm_sequence_cluster_kernel(
    const T* __restrict__ xg, const T* __restrict__ rw,
    const T* __restrict__ p_i, const T* __restrict__ p_f,
    const T* __restrict__ p_o, const T* __restrict__ h0,
    const T* __restrict__ c0, T* __restrict__ y, T* __restrict__ acts,
    T* __restrict__ hprev, T* __restrict__ cprev, T* __restrict__ c_final,
    int steps, int B, int H) {
  constexpr int NT = lc::NT, RV = R / 4;
  static_assert(R % 4 == 0, "a unit's R rows of h are whole float4");
  extern __shared__ float4 smem4[];
  const int Uc = lc::units(H), NCc = 4 * Uc, H4 = 4 * H;
  float* rw_s = reinterpret_cast<float*>(smem4);  // [H][4U]: rw_s[k][g*U+u] = RW[k][g*H+j0+u]
  float* hb = rw_s + H * NCc;                     // [2][H][R]: h_{t-1} by unit, then row
  float* pre_s = hb + 2 * H * R;                  // [2][R][4U]: this step's h.RW, by k half

  const unsigned q = lc::rank();
  const int j0 = (int)q * Uc;
  const int nu = max(0, min(Uc, H - j0));         // units this CTA owns (0 past H)
  const int b0 = blockIdx.y * R;
  const int nb = min(R, B - b0);                  // rows this cluster owns
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int idx = tid; idx < H * NCc; idx += NT) {
    const int k = idx / NCc, c = idx % NCc, u = c % Uc;
    rw_s[idx] = u < nu ? dl4j::to_f32(rw[(size_t)k * H4 + (c / Uc) * H + j0 + u]) : 0.0f;
  }
  for (int idx = tid; idx < 2 * H * R; idx += NT) {
    const int r = idx % R, k = (idx / R) % H;
    hb[idx] = idx < H * R && r < nb ? dl4j::to_f32(h0[(size_t)(b0 + r) * H + k]) : 0.0f;
  }

  // the gate thread of row gr, unit gu; gv: both exist
  const bool gate = tid < R * Uc;
  const int gr = gate ? tid / Uc : 0, gu = gate ? tid % Uc : 0;
  const bool gv = gate && gr < nb && gu < nu;
  const int gb = b0 + gr, gj = j0 + gu;
  float c = 0.0f, pi = 0.0f, pf = 0.0f, po = 0.0f, xr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (gv) {
    c = dl4j::to_f32(c0[(size_t)gb * H + gj]);
    pi = dl4j::to_f32(p_i[gj]);
    pf = dl4j::to_f32(p_f[gj]);
    po = dl4j::to_f32(p_o[gj]);
    const T* x = xg + (size_t)gb * H4 + gj;
#pragma unroll
    for (int g = 0; g < 4; ++g) xr[g] = dl4j::to_f32(x[g * H]);
  }
  // every CTA of the cluster has started and initialised its buffers
  // before any stores into them
  lc::sync();

  for (int t = 0; t < steps; ++t) {
    const float* hc = hb + (t & 1) * H * R;
    float* hn_buf = hb + ((t + 1) & 1) * H * R;
    if (lane < Uc) {
      // half of pre[r][g*U + lane], g = warp % 4: the sum over k ascending
      // of h[r][k] * RW column, k in the first half of 0..H-1 for warps
      // 0-3, the second half for warps 4-7
      const int g = warp & 3, half = warp >> 2;
      const int k0 = half ? (H + 1) / 2 : 0, k1 = half ? H : (H + 1) / 2;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      const float4* h4 = reinterpret_cast<const float4*>(hc);
      const float* w = rw_s + g * Uc + lane;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float wk = w[k * NCc];
#pragma unroll
        for (int v = 0; v < RV; ++v) {
          const float4 a = h4[RV * k + v];
          acc[4 * v] = fmaf(a.x, wk, acc[4 * v]);
          acc[4 * v + 1] = fmaf(a.y, wk, acc[4 * v + 1]);
          acc[4 * v + 2] = fmaf(a.z, wk, acc[4 * v + 2]);
          acc[4 * v + 3] = fmaf(a.w, wk, acc[4 * v + 3]);
        }
      }
      float* out = pre_s + half * R * NCc + g * Uc + lane;
#pragma unroll
      for (int r = 0; r < R; ++r) out[r * NCc] = acc[r];
    }
    __syncthreads();
    float ig = 0.0f, fg = 0.0f, gg = 0.0f, og = 0.0f, hn = 0.0f, cp = c;
    if (gv) {
      const float* p = pre_s + gr * NCc + gu;  // first half; p2: second
      const float* p2 = p + R * NCc;
      ig = dl4j::sigmoid(p[0] + p2[0] + xr[0] + c * pi);
      fg = dl4j::sigmoid(p[Uc] + p2[Uc] + xr[1] + c * pf);
      gg = tanhf(p[2 * Uc] + p2[2 * Uc] + xr[2]);
      c = fg * c + ig * gg;
      og = dl4j::sigmoid(p[3 * Uc] + p2[3 * Uc] + xr[3] + c * po);
      hn = og * tanhf(c);
      if (t + 1 < steps) hn_buf[gj * R + gr] = hn;
    }
    if (t + 1 < steps) {
      // all-gather: this CTA's units of the new h, [nu][R] f32 and
      // contiguous in the [H][R] buffer, into every other CTA of the
      // cluster, 16 bytes a store
      __syncthreads();
      lc::broadcast<NT>(reinterpret_cast<const float4*>(hn_buf + j0 * R), nu * R / 4, q);
      lc::arrive();
    }
    // the step's outputs, and step t+1's xg, do not take part in the
    // exchange: they go after the arrive, so the barrier's release does not
    // wait for them and the loads complete during the wait
    if (gv) {
      const size_t off = ((size_t)t * B + gb) * H + gj;
      const size_t aoff = ((size_t)t * B + gb) * H4 + gj;
      hprev[off] = dl4j::from_f32<T>(hc[gj * R + gr]);
      cprev[off] = dl4j::from_f32<T>(cp);
      acts[aoff] = dl4j::from_f32<T>(ig);
      acts[aoff + H] = dl4j::from_f32<T>(fg);
      acts[aoff + 2 * H] = dl4j::from_f32<T>(gg);
      acts[aoff + 3 * H] = dl4j::from_f32<T>(og);
      y[off] = dl4j::from_f32<T>(hn);
      if (t + 1 < steps) {
        const T* x = xg + ((size_t)(t + 1) * B + gb) * H4 + gj;
#pragma unroll
        for (int g = 0; g < 4; ++g) xr[g] = dl4j::to_f32(x[g * H]);
      } else {
        c_final[(size_t)gb * H + gj] = dl4j::from_f32<T>(c);
      }
    }
    if (t + 1 < steps) lc::wait();
  }
}

size_t cluster_smem(int H, int R) {
  const int Uc = lc::units(H);
  return (size_t)(4 * Uc * H + 2 * R * H + 2 * R * 4 * Uc) * sizeof(float);
}

template <typename T, int R>
int launch_cluster(const void* xg, const void* rw, const void* p_i,
                   const void* p_f, const void* p_o, const void* h0,
                   const void* c0, void* y, void* acts, void* hprev,
                   void* cprev, void* c_final, int steps, int B, int H,
                   cudaStream_t stream) {
  if (lc::units(H) > lc::UMAX) return cudaErrorInvalidValue;
  auto kern = lstm_sequence_cluster_kernel<T, R>;
  const size_t smem = cluster_smem(H, R);
  int max_clusters = 0;
  cudaError_t e = lc::prepare(kern, smem, &max_clusters);
  if (e != cudaSuccess) return e;
  lc::Config c((B + R - 1) / R, smem, stream);
  e = cudaLaunchKernelEx(&c.cfg, kern, static_cast<const T*>(xg),
                         static_cast<const T*>(rw), static_cast<const T*>(p_i),
                         static_cast<const T*>(p_f), static_cast<const T*>(p_o),
                         static_cast<const T*>(h0), static_cast<const T*>(c0),
                         static_cast<T*>(y), static_cast<T*>(acts),
                         static_cast<T*>(hprev), static_cast<T*>(cprev),
                         static_cast<T*>(c_final), steps, B, H);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int launch_rows(int rows, const void* xg, const void* rw, const void* p_i,
                const void* p_f, const void* p_o, const void* h0, const void* c0,
                void* y, void* acts, void* hprev, void* cprev, void* c_final,
                int steps, int B, int H, cudaStream_t s) {
  if (rows == 4)
    return launch_cluster<T, 4>(xg, rw, p_i, p_f, p_o, h0, c0, y, acts, hprev, cprev,
                                c_final, steps, B, H, s);
  if (rows == 8)
    return launch_cluster<T, 8>(xg, rw, p_i, p_f, p_o, h0, c0, y, acts, hprev, cprev,
                                c_final, steps, B, H, s);
  return cudaErrorInvalidValue;
}

template <typename T>
int occupancy(int H, int rows, int* max_clusters) {
  if (rows == 4)
    return lc::prepare(lstm_sequence_cluster_kernel<T, 4>, cluster_smem(H, 4), max_clusters);
  if (rows == 8)
    return lc::prepare(lstm_sequence_cluster_kernel<T, 8>, cluster_smem(H, 8), max_clusters);
  return cudaErrorInvalidValue;
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

// The cluster variant (H <= 256): no scratch. dtype as above; rows: the
// batch rows of a cluster, 4 or 8. Returns the launch's error code
// (0 = launched).
extern "C" int lstm_sequence_forward_cluster(
    int dtype, const void* xg, const void* rw, const void* p_i,
    const void* p_f, const void* p_o, const void* h0, const void* c0,
    void* y, void* acts, void* hprev, void* cprev, void* c_final, int steps,
    int B, int H, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rows<float>(rows, xg, rw, p_i, p_f, p_o, h0, c0, y, acts, hprev,
                              cprev, c_final, steps, B, H, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(rows, xg, rw, p_i, p_f, p_o, h0, c0, y, acts,
                                      hprev, cprev, c_final, steps, B, H, s);
  return cudaErrorInvalidValue;
}

// How many clusters of the cluster kernel (rows 4 or 8) the card holds at
// once (cudaOccupancyMaxActiveClusters) at hidden size H, into
// *max_clusters.
extern "C" int lstm_sequence_cluster_occupancy(int dtype, int H, int rows,
                                               int* max_clusters) {
  if (lc::units(H) > lc::UMAX) return cudaErrorInvalidValue;
  if (dtype == 0) return occupancy<float>(H, rows, max_clusters);
  if (dtype == 1) return occupancy<__nv_bfloat16>(H, rows, max_clusters);
  return cudaErrorInvalidValue;
}
