// Thread-block cluster pieces shared by the LSTM sequence kernels
// (lstm_sequence.cu, lstm_sequence_bwd.cu): the cluster geometry, the
// split cluster barrier, stores into another CTA's shared memory
// (distributed shared memory, DSMEM), and the launch with a cluster
// dimension.
//
// Geometry: the batch is cut across clusters of C CTAs, R rows each (R = 4
// or 8, a template argument: the caller takes 4 up to B = 64, at most 128
// CTAs on the H100's 132 SMs, so each CTA's share of the per-step product
// halves, and 8 past it); rows never depend on each other, so no
// exchange crosses a cluster. CTA q of a cluster owns hidden units q*U ..
// q*U+U-1 (U = ceil(H / C)) and keeps their four gate columns of RW in
// shared memory for all T steps. A lane of a warp takes one unit, so U <=
// 32: the cluster kernels take H <= C * 32 = 256. Thread r*U + u does the
// gate math of row r, unit u (R * U <= 256 threads). Every sum runs in an
// order fixed by H alone, so R and the number of clusters change no bit
// of the result.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dl4j {
namespace lstm_cluster {

constexpr int C = 8;        // CTAs per cluster: the portable cluster size
constexpr int NT = 256;     // threads per CTA: 8 warps
constexpr int UMAX = 32;    // most hidden units per CTA: one lane a unit

inline __host__ __device__ int units(int H) { return (H + C - 1) / C; }

__device__ __forceinline__ unsigned rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The cluster barrier in two halves: arrive publishes this thread's
// earlier writes (shared, DSMEM and global) to the cluster; wait returns
// once every thread of every CTA of the cluster has arrived, and makes
// their writes visible. Loads that do not depend on the exchange go
// between the two, so they complete during the wait. Every thread of the
// CTA must take both.
__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
__device__ __forceinline__ void sync() {
  arrive();
  wait();
}

// The shared::cluster address of `p`, a pointer into this CTA's shared
// memory, in CTA `q` of the cluster (the same offset in q's window).
__device__ __forceinline__ uint32_t remote(const float* p, unsigned q) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(q));
  return out;
}

__device__ __forceinline__ void store_remote(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void store_remote(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Copy n float4 of this CTA's shared memory at `p` to the same place in
// every other CTA of the cluster, all NT threads sharing the stores.
template <int NT>
__device__ __forceinline__ void broadcast(const float4* p, int n, unsigned self) {
  for (int i = threadIdx.x; i < (C - 1) * n; i += NT) {
    const int d = i / n, v = i % n;
    const unsigned q = d < (int)self ? d : d + 1;
    store_remote(remote(reinterpret_cast<const float*>(p + v), q), p[v]);
  }
}

// A launch of `clusters` clusters of C CTAs (grid C x clusters, cluster
// dimension C x 1 x 1), NT threads a CTA.
struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Config(int clusters, size_t smem, cudaStream_t stream) : cfg(), attr() {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(C, clusters, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// Give `kern` its dynamic shared memory and ask how many of its clusters
// the card holds at once. A cluster's CTAs spin on each other, so all C
// must be resident together: the launch itself guarantees that for each
// cluster, and fails if none fits, which this reports first. Clusters
// never wait on each other, so a grid with more clusters than fit at once
// runs in waves.
template <typename K>
cudaError_t prepare(K* kern, size_t smem, int* max_clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  Config c(1, smem, 0);
  e = cudaOccupancyMaxActiveClusters(max_clusters, kern, &c.cfg);
  if (e != cudaSuccess) return e;
  return *max_clusters >= 1 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

}  // namespace lstm_cluster
}  // namespace dl4j
