// Latency probes for the FFD scan's floor (sm_90a).
//
// The scans of ffd_pack.cu are chains of dependent steps: per class a
// fixed number of block (or cluster) barriers and of loads whose address
// depends on the previous load.  Their floor is therefore steps x
// (barriers x barrier round trip + dependent loads x L2 round trip), and
// these kernels measure the round trips on the card:
//
//   probe_barrier_kernel  one block of `threads` threads; each iteration
//                         writes shared memory, passes __syncthreads() and
//                         reads a neighbour's word (the pattern of the
//                         scan's block scans), double-buffered so one
//                         barrier per iteration is race free.
//   probe_chase_kernel    one thread follows a pointer chain with
//                         __ldcg (cached in L2, not L1); the chain visits
//                         one word per 128-byte line of a buffer that
//                         fits in L2, in an order the caller shuffles.
//   probe_cluster_barrier_kernel
//                         one cluster of `ctas` CTAs, launched with the
//                         cluster attribute: each iteration lane 31 of
//                         every warp stores a word into entry [parity]
//                         [rank * nw + warp] of every CTA's shared memory
//                         (st.shared::cluster), the cluster barrier is
//                         passed (arrive.release, wait.acquire) and each
//                         thread reads an entry back: the exchange of
//                         ffd_scan_cluster_kernel's class step.
//   probe_grid_exchange_kernel
//                         `clusters` co-resident clusters of `ctas` CTAs,
//                         launched with the cluster and cooperative
//                         attributes: each iteration is the cluster
//                         probe's exchange and barrier, then rank 0 of
//                         each cluster publishes a word tagged with the
//                         iteration into its entry of a row in device
//                         memory (st.release.gpu) and every warp spins
//                         until all the clusters' entries carry the tag
//                         (ld.acquire.gpu): the class step of
//                         ffd_scan_grid_kernel past one cluster, whose
//                         round trip through L2 between clusters is this
//                         probe's time less the cluster probe's.
//
//   probe_empty_grid_kernel
//                         does nothing, launched at another kernel's
//                         grid and block: that launch's
//                         floor (assemble_feasibility_kernel's in
//                         chip_smoke.py phase 15).
//
// The caller times two launches with different iteration counts and
// divides the difference, so the launch overhead cancels.

#include <cuda_runtime.h>

#include "common.cuh"  // the cluster's DSMEM stores and the grid's entries

namespace {

__global__ void probe_barrier_kernel(int iters, int* __restrict__ out) {
  __shared__ int sh[2][1024];
  int v = threadIdx.x;
  for (int i = 0; i < iters; ++i) {
    int* buf = sh[i & 1];
    buf[threadIdx.x] = v;
    __syncthreads();
    v += buf[(threadIdx.x + 1) % blockDim.x];
  }
  out[threadIdx.x] = v;
}

__global__ void probe_cluster_barrier_kernel(int iters, int* __restrict__ out) {
  __shared__ unsigned sh[2][256];
  unsigned rank, ctas;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(ctas));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, entries = ctas * nw;
  unsigned v = threadIdx.x;
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
  for (int i = 0; i < iters; ++i) {
    unsigned* buf = sh[i & 1];
    if (lane == 31) {
      const unsigned local = (unsigned)__cvta_generic_to_shared(buf + rank * nw + warp);
      for (unsigned r = 0; r < ctas; ++r) {
        unsigned a;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(local), "r"(r));
        asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
      }
    }
    asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
    v += buf[threadIdx.x % entries];
  }
  // no CTA exits while a peer may still store into it
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
  out[rank * blockDim.x + threadIdx.x] = v;
}

// A wait on another cluster that takes longer than this many cycles traps.
constexpr long long kProbeSpinBudget = 1ll << 32;

__global__ void probe_grid_exchange_kernel(int iters, unsigned long long* __restrict__ xg,
                                           int* __restrict__ out) {
  __shared__ unsigned sh[2][256];
  const unsigned rank = cluster_ctarank(), ctas = cluster_nctarank();
  const int q = blockIdx.x / ctas, Q = gridDim.x / ctas;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, entries = ctas * nw;
  unsigned v = threadIdx.x;
  cluster_sync();
  for (int i = 0; i < iters; ++i) {
    unsigned* buf = sh[i & 1];
    if (lane == 31)
      for (unsigned r = 0; r < ctas; ++r) st_cluster(cluster_addr(buf + rank * nw + warp, r), v);
    cluster_sync();
    v += buf[threadIdx.x % entries];
    unsigned long long* row = xg + (i & 1) * Q;
    if (rank == 0 && threadIdx.x == 0) publish_entry(row + q, (unsigned)(i + 1) << 1, v);
    v += (unsigned)await_entries(row, Q, (unsigned)(i + 1), kProbeSpinBudget);
  }
  cluster_sync();  // no CTA exits while a peer may still store into it
  out[blockIdx.x * blockDim.x + threadIdx.x] = v;
}

// Does nothing: a launch of it is the floor of any launch of its grid.
__global__ void probe_empty_grid_kernel() {}

__global__ void probe_chase_kernel(const int* __restrict__ next, int steps,
                                   int* __restrict__ out) {
  int p = 0;
  for (int i = 0; i < steps; ++i) p = __ldcg(next + p);
  *out = p;
}

}  // namespace

extern "C" {

// Each returns the CUDA error code of the launch (0 = launched).
int probe_barrier(int threads, int iters, int* out, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0) return -1;
  probe_barrier_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(iters, out);
  return (int)cudaGetLastError();
}

// An empty launch of grid (gx, gy, gz) of blocks (bx, by): the shape of
// another kernel's launch.
int probe_empty_grid(int gx, int gy, int gz, int bx, int by, void* stream) {
  if (gx < 1 || gy < 1 || gz < 1 || bx < 1 || by < 1 || bx * by > 1024) return -1;
  probe_empty_grid_kernel<<<dim3(gx, gy, gz), dim3(bx, by), 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

int probe_chase(const int* next, int steps, int* out, void* stream) {
  probe_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, out);
  return (int)cudaGetLastError();
}

// One cluster of `ctas` (2, 4 or 8) CTAs of `threads` threads; `out` holds
// ctas * threads ints.
int probe_cluster_barrier(int ctas, int threads, int iters, int* out, void* stream) {
  if ((ctas != 2 && ctas != 4 && ctas != 8) || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.stream = (cudaStream_t)stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&config, probe_cluster_barrier_kernel, iters, out);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// `clusters` (2 to 32) clusters of `ctas` (2, 4 or 8) CTAs of `threads`
// threads, all resident at once (the cooperative attribute); `xg` holds 2 *
// clusters zeroed entries, `out` clusters * ctas * threads ints.
int probe_grid_exchange(int clusters, int ctas, int threads, int iters,
                        unsigned long long* xg, int* out, void* stream) {
  if (clusters < 2 || clusters > 32 || (ctas != 2 && ctas != 4 && ctas != 8) ||
      threads < 32 || threads > 1024 || threads % 32 != 0)
    return -1;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * ctas, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.stream = (cudaStream_t)stream;
  config.attrs = attr;
  config.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(&config, probe_grid_exchange_kernel, iters, xg, out);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
