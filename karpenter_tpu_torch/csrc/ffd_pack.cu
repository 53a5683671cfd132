// First-fit-decreasing (FFD) class scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pack_step` (karpenter_tpu/ops/pallas_packer.py,
// launched by `_pallas_pack` through pl.pallas_call) and computes the
// function of `_pack_core` (karpenter_tpu/ops/packer.py), which both JAX
// kernels share.  The plain PyTorch version is
// karpenter_tpu_torch/ops/packer.py:pack_reference; the Python wrappers are
// karpenter_tpu_torch/ops/fused_packer.py.
//
// Two launches:
//   choose_config_kernel  grid (Gp,): one block per class picks the config a
//                         new node of that class opens on (first-index
//                         argmin of the objective's score over C, as a block
//                         reduction of (score, index) pairs).
//   ffd_scan_kernel       grid (1,): one block walks the Gp classes in order.
//                         Per class: per-slot capacity, a block-wide
//                         exclusive int32 prefix over K (chunks of
//                         blockDim with a running carry), first-fit takes,
//                         an integer ceil-div window of new slots, and the
//                         state updates.
//
// What bounds it: the scan is latency-bound, not byte- or FLOP-bound.  Its
// inputs are ~1.3 MB of feasibility plus ~330 KB of take output at the
// bench shapes, but it is Gp sequential steps of a few block barriers each.
// The design keeps every per-slot value owned by one thread (slot k is
// always handled by thread k % blockDim), so the only barriers per class
// are those of the prefix and the two sums; the slot state (used, cfg,
// npods, sigcnt) lives in the output buffers and stays in L2 at these
// sizes.  Unlike the TPU kernel it gathers feas[g, cfg[k]] directly and
// counts in exact int32, so it needs neither the signature admission table
// nor the f32 ceil-overshoot mask, and takes any S, R and T.
//
// Float rules (bit-equality with the JAX CPU reference): IEEE division and
// no contraction of `used + take * req` (explicit __fdiv_rn / __fmul_rn /
// __fadd_rn; the library is built without --use_fast_math), first-index
// argmin, int32 wraparound where JAX wraps (prefix and sums in unsigned
// arithmetic).  Per-slot capacities are clamped to 2^30 before the int
// conversion; every use then takes the minimum with the class cap, which
// is at most 2^30, so the clamp changes no result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBigF = 1073741824.0f;  // 2^30
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
__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}
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

__global__ void choose_config_kernel(const float* __restrict__ req,
                                     const int* __restrict__ maxper,
                                     const uint8_t* __restrict__ feas,
                                     const float* __restrict__ alloc,
                                     const float* __restrict__ price,
                                     const uint8_t* __restrict__ openable,
                                     int Cp, int R, int objective,
                                     int* __restrict__ c_star,
                                     int* __restrict__ new_ok,
                                     int* __restrict__ per) {
  extern __shared__ float sreq[];  // [R]
  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int r = threadIdx.x; r < R; r += blockDim.x) sreq[r] = req[(size_t)g * R + r];

  // price ceiling: max(where(openable, price, 0)) + 1
  float pm = -INFINITY;
  for (int c = threadIdx.x; c < Cp; c += blockDim.x)
    pm = fmaxf(pm, openable[c] ? price[c] : 0.0f);
  for (int o = 16; o > 0; o >>= 1) pm = fmaxf(pm, __shfl_down_sync(kFull, pm, o));
  if (lane == 0) s_val[warp] = pm;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nw ? s_val[lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) w = fmaxf(w, __shfl_down_sync(kFull, w, o));
    if (lane == 0) s_val[0] = w;
  }
  __syncthreads();
  const float price_ceil = __fadd_rn(s_val[0], 1.0f);
  __syncthreads();

  const int mp = maxper[g];
  const uint8_t* feas_g = feas + (size_t)g * Cp;
  float best = INFINITY;
  int bidx = 0x7fffffff;
  for (int c = threadIdx.x; c < Cp; c += blockDim.x) {
    const int cap = min(node_cap(alloc + (size_t)c * R, nullptr, sreq, R), mp);
    float score = INFINITY;
    if (feas_g[c] && openable[c] && cap > 0) {
      const float capf = (float)cap;
      score = objective == 1
                  ? __fdiv_rn(price[c], capf)
                  : __fadd_rn(-capf, __fdiv_rn(price[c], price_ceil));
    }
    if (score < best || (score == best && c < bidx)) {
      best = score;
      bidx = c;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_down_sync(kFull, best, o);
    const int oi = __shfl_down_sync(kFull, bidx, o);
    if (os < best || (os == best && oi < bidx)) {
      best = os;
      bidx = oi;
    }
  }
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = bidx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nw; ++w) {
      if (s_val[w] < best || (s_val[w] == best && s_idx[w] < bidx)) {
        best = s_val[w];
        bidx = s_idx[w];
      }
    }
    const int c = bidx;
    const int cap = min(node_cap(alloc + (size_t)c * R, nullptr, sreq, R), mp);
    c_star[g] = c;
    new_ok[g] = (feas_g[c] && openable[c] && cap > 0) ? 1 : 0;
    per[g] = max(cap, 1);
  }
}

__global__ void ffd_scan_kernel(
    const float* __restrict__ req, const int* __restrict__ cnt,
    const int* __restrict__ maxper, const int* __restrict__ slot,
    const uint8_t* __restrict__ feas, const float* __restrict__ alloc,
    const int* __restrict__ c_star, const int* __restrict__ new_ok,
    const int* __restrict__ per, const float* __restrict__ used0,
    const int* __restrict__ cfg0, const int* __restrict__ npods0,
    const int* __restrict__ sig0, int Gp, int Cp, int K, int R, int S,
    int next0, int* __restrict__ take, int* __restrict__ leftover,
    int* __restrict__ cfg, int* __restrict__ npods, float* __restrict__ used,
    int* __restrict__ sigcnt) {
  extern __shared__ float sreq[];  // [R]
  __shared__ unsigned sh[32];
  const int B = blockDim.x;

  // slot state starts from the prefill; slot k belongs to thread k % B in
  // every phase, so no barrier is needed between per-slot updates
  for (int k = threadIdx.x; k < K; k += B) {
    cfg[k] = cfg0[k];
    npods[k] = npods0[k];
    for (int r = 0; r < R; ++r) used[(size_t)k * R + r] = used0[(size_t)k * R + r];
    for (int s = 0; s < S; ++s) sigcnt[(size_t)s * K + k] = sig0[(size_t)s * K + k];
  }

  int nxt = next0;
  for (int g = 0; g < Gp; ++g) {
    for (int r = threadIdx.x; r < R; r += B) sreq[r] = req[(size_t)g * R + r];
    __syncthreads();
    const int n = cnt[g], mp = maxper[g], s = slot[g];
    const uint8_t* feas_g = feas + (size_t)g * Cp;
    int* take_g = take + (size_t)g * K;
    int* sig_s = sigcnt + (size_t)s * K;

    // ---- fill open slots, first fit in slot order -----------------------
    unsigned carry = 0u, t1_local = 0u;
    for (int base = 0; base < K; base += B) {
      const int k = base + threadIdx.x;
      int cap = 0;
      if (k < K) {
        const int c = cfg[k];
        if (c >= 0 && feas_g[c]) {
          cap = node_cap(alloc + (size_t)c * R, used + (size_t)k * R, sreq, R);
          cap = min(cap, max(wsub(mp, sig_s[k]), 0));
        }
      }
      unsigned chunk;
      const unsigned incl = block_incl_scan((unsigned)cap, &chunk, sh);
      const int prefix = (int)(carry + incl - (unsigned)cap);
      const int t1 = clip(wsub(n, prefix), 0, cap);
      if (k < K) take_g[k] = t1;
      t1_local += (unsigned)t1;
      carry += chunk;
    }
    const int n2 = wsub(n, (int)block_sum(t1_local, sh));

    // ---- open new slots on the precomputed best config ------------------
    const int pg = per[g];
    const int need = new_ok[g] ? floordiv(wadd(n2, pg - 1), pg) : 0;
    const int opened = min(need, K - nxt);
    const int cs = c_star[g];
    unsigned t2_local = 0u;
    for (int k = threadIdx.x; k < K; k += B) {
      const bool win = k >= nxt && k < nxt + opened;
      const int t2 = win ? clip(wsub(n2, wmul(k - nxt, pg)), 0, pg) : 0;
      const int t = wadd(take_g[k], t2);
      take_g[k] = t;
      const float tf = (float)t;
      for (int r = 0; r < R; ++r) {
        float* u = used + (size_t)k * R + r;
        *u = __fadd_rn(*u, __fmul_rn(tf, sreq[r]));
      }
      if (win) cfg[k] = cs;
      npods[k] = wadd(npods[k], t);
      sig_s[k] = wadd(sig_s[k], t);
      t2_local += (unsigned)t2;
    }
    const unsigned t2_sum = block_sum(t2_local, sh);
    if (threadIdx.x == 0) leftover[g] = wsub(n2, (int)t2_sum);
    nxt += opened;
  }
}

int scan_threads(int K) {
  int b = ((K + 31) / 32) * 32;
  return b < 32 ? 32 : (b > 1024 ? 1024 : b);
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 = launched).
int ffd_choose_config(const float* req, const int* maxper, const uint8_t* feas,
                      const float* alloc, const float* price,
                      const uint8_t* openable, int Gp, int Cp, int R,
                      int objective, int* c_star, int* new_ok, int* per,
                      void* stream) {
  if (Gp <= 0) return 0;
  choose_config_kernel<<<Gp, 256, R * sizeof(float), (cudaStream_t)stream>>>(
      req, maxper, feas, alloc, price, openable, Cp, R, objective, c_star,
      new_ok, per);
  return (int)cudaGetLastError();
}

int ffd_scan(const float* req, const int* cnt, const int* maxper,
             const int* slot, const uint8_t* feas, const float* alloc,
             const int* c_star, const int* new_ok, const int* per,
             const float* used0, const int* cfg0, const int* npods0,
             const int* sig0, int Gp, int Cp, int K, int R, int S, int next0,
             int* take, int* leftover, int* cfg, int* npods, float* used,
             int* sigcnt, void* stream) {
  if (K <= 0) return 0;
  ffd_scan_kernel<<<1, scan_threads(K), R * sizeof(float),
                    (cudaStream_t)stream>>>(
      req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per, used0, cfg0,
      npods0, sig0, Gp, Cp, K, R, S, next0, take, leftover, cfg, npods, used,
      sigcnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
