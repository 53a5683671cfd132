// Latency probes for the FFD scan's floor (sm_90a).
//
// `ffd_scan_kernel` (ffd_pack.cu) is a chain of dependent steps: per class
// a fixed number of block barriers and of loads whose address depends on
// the previous load.  Its floor is therefore steps x (barriers x barrier
// round trip + dependent loads x L2 round trip), and these two kernels
// measure the two round trips on the card:
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
//
// The caller times two launches with different iteration counts and
// divides the difference, so the launch overhead cancels.

#include <cuda_runtime.h>

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

int probe_chase(const int* next, int steps, int* out, void* stream) {
  probe_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
