// Device helpers shared by the package's CUDA sources (ffd_pack.cu and
// mesh_pack.cu): the float constants and the capacity of the JAX
// package's _per_node_cap, int32 arithmetic that wraps as XLA's does, the
// block-wide scan over unsigned (wrapping) values, and the
// order-preserving key of a float32 score.  Each source includes it into
// its own translation unit (an anonymous namespace: nothing is exported).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBigF = 1073741824.0f;  // 2^30: tensorize.BIG
constexpr float kNudge = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
// floor division (jnp's // on int32)
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// _per_node_cap: copies of `req` that fit in alloc_row - used_row
// (used_row may be null), over the R axes the class requests.
__device__ __forceinline__ int node_cap(const float* alloc_row,
                                        const float* used_row,
                                        const float* req, int R) {
  float cap = kBigF;
  for (int r = 0; r < R; ++r) {
    const float q = req[r];
    if (q > 0.0f) {
      const float rem =
          used_row ? __fsub_rn(alloc_row[r], used_row[r]) : alloc_row[r];
      cap = fminf(cap, floorf(__fadd_rn(__fdiv_rn(rem, q), kNudge)));
    }
  }
  return (int)fmaxf(cap, 0.0f);
}

// Order-preserving uint32 key of a float32 score (-0.0 and +0.0 one key):
// the least (key, index) over any split of the configs is the first-index
// argmin (ops/packer.py: score_keys).
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Block-wide inclusive scan of unsigned (wrapping) values; blockDim.x is a
// multiple of 32 and at most 1024.  `sh` holds 32 words.  Ends with a
// barrier, so `sh` may be reused by the next call.
__device__ unsigned block_incl_scan(unsigned v, unsigned* total,
                                    unsigned* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < nw ? sh[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    sh[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += sh[warp - 1];
  *total = sh[nw - 1];
  __syncthreads();
  return v;
}

__device__ unsigned block_sum(unsigned v, unsigned* sh) {
  unsigned total;
  block_incl_scan(v, &total, sh);
  return total;
}

}  // namespace
