// The sharded pack over a device mesh, for Hopper (sm_90a).
//
// Replaces the jitted XLA functions of karpenter_tpu/parallel/mesh.py
// (assemble_feasibility, and _pack_core of karpenter_tpu/ops/packer.py
// under sharded_solve_step / _sharded_pack / mesh_pack_fn, which GSPMD
// partitions over a (data, model) mesh).  The plain PyTorch versions are
// karpenter_tpu_torch/ops/packer.py (*_reference, mesh_pack_reference); the
// Python wrappers and the host loop over the classes are
// karpenter_tpu_torch/ops/fused_packer.py (mesh_pack), the exchange copies
// ops/packer.py (mesh_shards, mesh_exchange_row, mesh_outputs).
//
// The mesh is single-controller: one process holds a D x M grid of devices
// and launches each shard's kernel on its own device's current stream.
// The data axis shards the slot axis K, the model axis the config axis C of
// the [G, C] passes; the class axis G stays sequential.  Three kernels here:
//   assemble_feasibility_kernel  grid (ceil(n / 256),): one tile (classes
//       [g0, g1) x configs [c0, c1)) of the dense feasibility mask from the
//       factorized admission, one byte a thread.
//   ffd_shard_cap_kernel         grid (1,): one data shard closes class g-1
//       on its slots (from the exchanged take1 sums: n2, the window of
//       take2, the fused usage update, cfg, npods, the signature counters,
//       the leftover and the next free slot), then computes class g's
//       per-slot cap and its wrapped int32 total.
//   ffd_shard_apply_kernel       grid (1,): given the exchanged totals,
//       the shard's prefix offset (the wrapped sum of the totals of the
//       shards before it), its first-fit take1 and their wrapped sum.
// The fourth, the choice tile (one model shard's per-class first-index
// best config against the price ceiling of the whole catalog, as a record
// of order-preserving score key, global index, cap and ok), is the shard
// mode of ffd_pack.cu's choose_config_kernel (choose_config_kernel<., true>,
// entry ffd_choose_config_shard).  The host copies every tile's records to
// every data row, where the cap kernel takes the least (key, index): the
// global first-index argmin.
// Between the cap and the apply, and after the apply, each shard's int32
// (the totals, then the take1 sums) reaches every shard: the shards of one
// device share its exchange buffer (one column a shard), and the buffers
// of different devices meet through copies (ops/packer.py
// mesh_exchange_row).  Two exchanges a class, not one: with int32
// wraparound sum(take1) is not a function of the totals (a prefix that
// wraps negative lets a later slot take pods), so n2 needs every shard's
// own sum.  The close of class g-1 rides the cap launch of class g, so a
// class costs two launches a shard.
//
// What bounds it: the chain of launches (and copies between devices), not
// bytes or operations.  Each kernel is one block over a shard's slots with the
// state in device memory (the simple form); a later design keeps the state
// resident and exchanges through peer memory (ROADMAP).
//
// Float rules as ffd_pack.cu: IEEE division (__fdiv_rn), no fast math, the
// usage update one __fmaf_rn.  int32 arithmetic wraps as XLA's does
// (computed in unsigned), division of negatives floors.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"  // the wrapping int32 helpers, node_cap, block scans

// One data shard's buffers (ops/fused_packer.py: ShardArgs).
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
  int* cap;                // [Kd] scratch: class g's caps
  int* nxt;                // [1] the first free slot
  int G, C, R, S, M, D, d, k0, Kd, K;
};

namespace {

constexpr int kRec = 4;                 // ops/packer.py: MESH_REC
constexpr int kAssembleThreads = 256;
constexpr int kShardThreads = 1024;     // the most a shard launch takes

// sum(take2) over the window's slots that exist (ops/packer.py:
// window_take_sum): where the window is not empty, n2 > 0 and no term of
// it overflows.
__device__ __forceinline__ int window_take_sum(int n2, int per, int nxt,
                                               int opened) {
  if (opened <= 0) return 0;
  const long long j0 = min(max(-(long long)nxt, 0ll), (long long)opened);
  const long long all = min((long long)n2, (long long)opened * per);
  const long long below = min((long long)n2, j0 * per);
  return (int)(all - below);
}

__global__ void __launch_bounds__(kAssembleThreads) assemble_feasibility_kernel(
    const uint8_t* __restrict__ type_ok, const uint8_t* __restrict__ zone_ok,
    const uint8_t* __restrict__ ct_ok, const int* __restrict__ sig_of,
    const int* __restrict__ t_of, const int* __restrict__ z_of,
    const int* __restrict__ ct_of, int T, int Z, int CT, int g0, int g1,
    int c0, int c1, uint8_t* __restrict__ out) {
  const int w = c1 - c0;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(g1 - g0) * w) return;
  const int g = g0 + (int)(i / w), c = c0 + (int)(i % w);
  const long long s = sig_of[g];
  out[i] = (type_ok[s * T + t_of[c]] && zone_ok[s * Z + z_of[c]] &&
            ct_ok[s * CT + ct_of[c]]) ? 1 : 0;
}

__global__ void __launch_bounds__(kShardThreads) ffd_shard_cap_kernel(
    ShardArgs a, int g) {
  __shared__ unsigned sh[32];
  const int t = threadIdx.x, nt = blockDim.x;
  if (g > 0) {  // close class g - 1
    const int gp = g - 1;
    unsigned bk = 0xffffffffu;
    int c_star = 0x7fffffff, bcap = 0, new_ok = 0;
    for (int m = 0; m < a.M; ++m) {
      const int* r = a.rec + ((size_t)m * a.G + gp) * kRec;
      const unsigned k = (unsigned)r[0];
      if (k < bk || (k == bk && r[1] < c_star)) {
        bk = k;
        c_star = r[1];
        bcap = r[2];
        new_ok = r[3];
      }
    }
    const int per = max(bcap, 1);
    unsigned lsum = 0;
    for (int d = 0; d < a.D; ++d)
      lsum += (unsigned)a.xchg[((size_t)a.G + gp) * a.D + d];
    const int n2 = wsub(a.cnt[gp], (int)lsum);
    const int nxt = *a.nxt;
    const int need = new_ok ? floordiv(wsub(wadd(n2, per), 1), per) : 0;
    const int opened = min(need, wsub(a.K, nxt));
    const int hi = wadd(nxt, opened);
    const float* rq = a.req + (size_t)gp * a.R;
    int* sig = a.sig + (size_t)a.slot[gp] * a.Kd;
    int* take = a.take + (size_t)gp * a.Kd;
    for (int k = t; k < a.Kd; k += nt) {
      const int idx = a.k0 + k;
      const bool win = idx >= nxt && idx < hi;
      int t2 = 0;
      if (win)
        t2 = min(max(wsub(n2, wmul(wsub(idx, nxt), per)), 0), per);
      const int tk = wadd(take[k], t2);
      take[k] = tk;
      const float tf = (float)tk;
      float* u = a.used + (size_t)k * a.R;
      for (int r = 0; r < a.R; ++r) u[r] = __fmaf_rn(tf, rq[r], u[r]);
      if (win) a.cfg[k] = c_star;
      a.npods[k] = wadd(a.npods[k], tk);
      sig[k] = wadd(sig[k], tk);
    }
    __syncthreads();  // every thread has read *a.nxt
    if (t == 0) {
      a.leftover[gp] = wsub(n2, window_take_sum(n2, per, nxt, opened));
      *a.nxt = hi;
    }
  }
  if (g >= a.G) return;
  // class g's caps; each thread reads back only the slots it updated
  const float* rq = a.req + (size_t)g * a.R;
  const uint8_t* fg = a.feas + (size_t)g * a.C;
  const int mp = a.maxper[g];
  const int* sig = a.sig + (size_t)a.slot[g] * a.Kd;
  unsigned tot = 0;
  for (int k = t; k < a.Kd; k += nt) {
    const int c = a.cfg[k];
    int cap = 0;
    if (c >= 0 && fg[c]) {
      cap = node_cap(a.alloc + (size_t)c * a.R, a.used + (size_t)k * a.R, rq, a.R);
      cap = min(cap, max(wsub(mp, sig[k]), 0));
    }
    a.cap[k] = cap;
    tot += (unsigned)cap;
  }
  tot = block_sum(tot, sh);
  if (t == 0) a.xchg[(size_t)g * a.D + a.d] = (int)tot;
}

__global__ void __launch_bounds__(kShardThreads) ffd_shard_apply_kernel(
    ShardArgs a, int g) {
  __shared__ unsigned sh[32];
  const int t = threadIdx.x, nt = blockDim.x;
  unsigned off = 0;
  for (int d = 0; d < a.d; ++d) off += (unsigned)a.xchg[(size_t)g * a.D + d];
  // thread t owns the contiguous slots [lo, hi): a serial prefix over them
  // after a block scan of the threads' sums
  const int per_t = (a.Kd + nt - 1) / nt;
  const int lo = min(t * per_t, a.Kd), hi = min(lo + per_t, a.Kd);
  unsigned mine = 0;
  for (int k = lo; k < hi; ++k) mine += (unsigned)a.cap[k];
  unsigned total;
  unsigned run = off + block_incl_scan(mine, &total, sh) - mine;
  const int n = a.cnt[g];
  int* take = a.take + (size_t)g * a.Kd;
  unsigned lsum = 0;
  for (int k = lo; k < hi; ++k) {
    const int c = a.cap[k];
    const int t1 = min(max(wsub(n, (int)run), 0), c);
    take[k] = t1;
    lsum += (unsigned)t1;
    run += (unsigned)c;
  }
  lsum = block_sum(lsum, sh);
  if (t == 0) a.xchg[((size_t)a.G + g) * a.D + a.d] = (int)lsum;
}

int shard_threads(int Kd) {
  const int t = (Kd + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kShardThreads ? kShardThreads : t);
}

// Launch on `device` (the caller's device restored after), on `stream`.
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

}  // namespace

extern "C" {

int mesh_assemble_feasibility(const uint8_t* type_ok, const uint8_t* zone_ok,
                              const uint8_t* ct_ok, const int* sig_of,
                              const int* t_of, const int* z_of,
                              const int* ct_of, int T, int Z, int CT, int g0,
                              int g1, int c0, int c1, uint8_t* out,
                              int device, void* stream) {
  OnDevice on(device);
  const long long n = (long long)(g1 - g0) * (c1 - c0);
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kAssembleThreads - 1) / kAssembleThreads);
    assemble_feasibility_kernel<<<blocks, kAssembleThreads, 0,
                                  (cudaStream_t)stream>>>(
        type_ok, zone_ok, ct_ok, sig_of, t_of, z_of, ct_of, T, Z, CT, g0, g1,
        c0, c1, out);
  }
  return (int)cudaGetLastError();
}

int mesh_shard_cap(const ShardArgs* a, int g, int device, void* stream) {
  OnDevice on(device);
  ffd_shard_cap_kernel<<<1, shard_threads(a->Kd), 0, (cudaStream_t)stream>>>(*a, g);
  return (int)cudaGetLastError();
}

int mesh_shard_apply(const ShardArgs* a, int g, int device, void* stream) {
  OnDevice on(device);
  ffd_shard_apply_kernel<<<1, shard_threads(a->Kd), 0, (cudaStream_t)stream>>>(*a, g);
  return (int)cudaGetLastError();
}


}  // extern "C"
