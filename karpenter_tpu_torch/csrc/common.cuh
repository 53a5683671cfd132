// Device helpers shared by the package's CUDA sources (ffd_pack.cu,
// mesh_pack.cu and latency_probe.cu): the float constants and the capacity
// of the JAX package's _per_node_cap, int32 arithmetic that wraps as XLA's
// does, the block-wide scan over unsigned (wrapping) values, the order-preserving
// key of a float32 score, and what the resident scans are built from: the
// cp.async ring of feasibility rows, the tiles of class rows, and the
// thread-block cluster's shared-memory stores and barrier, and the tagged
// device-memory entries through which a grid of clusters exchanges a
// value (the grid scan; the latency probe times them); and what the
// device mesh's data shards share: their buffers (ShardArgs), the choice
// combined from the model shards' records, the closed-form leftover.  Each
// source includes it into its own translation unit (an anonymous
// namespace: nothing is exported but the layout of ShardArgs).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// One data shard of the device mesh's sharded pack, its buffers as the
// Python wrappers hold them (ops/fused_packer.py: ShardArgs).
struct ShardArgs {
  // the row device's replica (read only)
  const float* req;        // [G, R]
  const int* cnt;          // [G]
  const int* maxper;       // [G]
  const int* slot;         // [G]
  const uint8_t* feas;     // [G, C]
  const float* alloc;      // [C, R]
  const int* rec;          // [M, G, kRec] every model shard's choice record
  // the shard's own buffers
  int* xchg;               // [2, G, D]: 0 the totals, 1 the take1 sums
  float* used;             // [Kd, R]
  int* cfg;                // [Kd]
  int* npods;              // [Kd]
  int* sig;                // [S, Kd]
  int* take;               // [G, Kd]
  int* leftover;           // [G]
  int* cap;                // [Kd] scratch: class g's caps (the pair's)
  int* nxt;                // [1] the first free slot
  int G, C, R, S, M, D, d, k0, Kd, K;
};

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

// node_cap over a slot's state in shared memory, laid out [R][stride],
// over the axes the class requests (req[r] > 0).
__device__ __forceinline__ int node_cap_strided(const float* alloc_k,
                                                const float* used_k, int stride,
                                                const float* req, int R) {
  float cap = kBigF;
  for (int r = 0; r < R; ++r) {
    const float q = req[r];
    if (q > 0.0f) {
      const float rem = __fsub_rn(alloc_k[r * stride], used_k[r * stride]);
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

// ---- the resident scans' ring of feasibility rows and tiles of class rows

constexpr int kRing = 8;   // feasibility rows in flight
constexpr int kTile = 32;  // classes per tile of class rows

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One cp.async of 4, 8 or 16 bytes (16 goes to L2 only, the form that size
// takes); both addresses aligned to the size.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
                 "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Base row hr's feasibility row into a ring slot, in `chunk`-byte copies.
__device__ __forceinline__ void issue_feas(int hr, unsigned char* dst, int chunk,
                                           const uint8_t* feas, int Cp) {
  const uint8_t* row = feas + (size_t)hr * Cp;
  for (int i = threadIdx.x * chunk; i < Cp; i += blockDim.x * chunk)
    cp_async(dst + i, row + i, chunk);
}

// Classes [h0, h0 + kTile) into a tile of W words a class, word f of class
// h being word(h, f) (0 past class Gp - 1).  Plain loads: the tile is used
// steps later, so only its own load waits.
template <class Word>
__device__ __forceinline__ void load_rows(int h0, int* tile, int Gp, int W, Word word) {
#pragma unroll 4
  for (int i = threadIdx.x; i < kTile * W; i += blockDim.x) {
    const int h = h0 + i / W, f = i % W;
    tile[i] = h < Gp ? word(h, f) : 0;
  }
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ---- a thread-block cluster: its CTAs' shared memory (DSMEM) and barrier

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned n;
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// `p` (in this CTA's shared memory) as a shared::cluster address in the
// shared memory of cluster CTA `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ void st_cluster(unsigned addr, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_cluster2(unsigned addr, unsigned a, unsigned b) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b)
               : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// ---- a grid of co-resident clusters: tagged entries in device memory

// One cluster's entry of a class: the tag word (high) and the value word
// (low) in one 64-bit store, so a reader sees both of one publication.
__device__ __forceinline__ void publish_entry(unsigned long long* entry, unsigned tag,
                                              unsigned value) {
  const unsigned long long v = ((unsigned long long)tag << 32) | value;
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(entry), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long read_entry(const unsigned long long* entry) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(entry) : "memory");
  return v;
}

// Spins the calling warp until entry j of row[0 .. n) (n <= 32) carries a
// tag word whose bits above the lowest equal `tag`; returns entry `lane`
// in each lane j < n (0 in the others).  A spin that outlasts `budget`
// clock cycles traps: a lost entry ends the launch with an error instead
// of hanging it.
__device__ __forceinline__ unsigned long long await_entries(const unsigned long long* row,
                                                            int n, unsigned tag,
                                                            long long budget) {
  const int lane = threadIdx.x & 31;
  unsigned long long e = 0ull;
  bool ok = lane >= n;
  const long long t0 = clock64();
  while (true) {
    if (!ok) {
      e = read_entry(row + lane);
      ok = (unsigned)(e >> 33) == tag;
    }
    if (__all_sync(kFull, ok)) return e;
    if (clock64() - t0 > budget) __trap();
  }
}

// ---- the device mesh's data shards

constexpr int kRec = 4;        // a choice record's words (ops/packer.py: MESH_REC)
constexpr int kMaxShards = 8;  // data shards of one cluster launch (a portable cluster)

// Where a class's new nodes open: its config, whether it may open one, and
// the pods a new node takes (at least 1).
struct Choice {
  int c_star, ok, per;
};

// Class h's choice over the M model shards' records rec [M, G, kRec]
// (score key, config index, cap, ok): the record of the least (key,
// index), the global first-index argmin (ops/packer.py: combine_choice).
__device__ __forceinline__ Choice best_choice(const int* rec, int M, int G, int h) {
  const int* best = rec + (size_t)h * kRec;
  unsigned bk = (unsigned)best[0];
  int bi = best[1];
  for (int m = 1; m < M; ++m) {
    const int* r = rec + ((size_t)m * G + h) * kRec;
    const unsigned k = (unsigned)r[0];
    if (k < bk || (k == bk && r[1] < bi)) {
      bk = k;
      bi = r[1];
      best = r;
    }
  }
  return Choice{bi, best[3], max(best[2], 1)};
}

// sum(take2) over the window's slots that exist (ops/packer.py:
// window_take_sum): where the window is not empty, n2 > 0 and no term of
// it overflows.
__device__ __forceinline__ int window_take_sum(int n2, int per, int nxt, int opened) {
  if (opened <= 0) return 0;
  const long long j0 = min(max(-(long long)nxt, 0ll), (long long)opened);
  const long long all = min((long long)n2, (long long)opened * per);
  const long long below = min((long long)n2, j0 * per);
  return (int)(all - below);
}

// A launch on `device` (the caller's device restored after).
struct OnDevice {
  int prev = -1;
  explicit OnDevice(int device) {
    cudaGetDevice(&prev);
    if (prev != device) cudaSetDevice(device);
  }
  ~OnDevice() {
    int now = -1;
    cudaGetDevice(&now);
    if (now != prev) cudaSetDevice(prev);
  }
};

// Wrapped sum of part[0 .. count), in every lane of the calling warp.
__device__ __forceinline__ unsigned warp_sum_of(const unsigned* part, int count) {
  unsigned v = 0u;
  for (int j = threadIdx.x & 31; j < count; j += 32) v += part[j];
  return warp_sum(v);
}

}  // namespace
