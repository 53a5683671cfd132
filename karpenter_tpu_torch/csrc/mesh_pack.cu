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
// the [G, C] passes; the class axis G stays sequential.  The kernels here:
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
// These two are the pair the pack launches per class and shard where the
// data rows lie on several devices, or where a CTA cannot hold a shard.
// Where every data row sits on one device the pack instead takes the whole
// scan in one launch: the shard mode of ffd_pack.cu's cluster scan
// (ffd_scan_cluster_kernel<M, kShard>, entry mesh_shard_scan), a CTA a
// data shard, its state resident in the CTA's shared memory and the
// per-class exchanges through the cluster's (ops/fused_packer.py:
// shard_scan_kernel picks).
// The choice tile (one model shard's per-class first-index best config
// against the price ceiling of the whole catalog, as a record of
// order-preserving score key, global index, cap and ok) is the shard mode
// of ffd_pack.cu's choose_config_kernel (choose_config_kernel<., true>,
// entry ffd_choose_config_shard).  The host copies every tile's records to
// every data row, where the scan takes the least (key, index): the global
// first-index argmin (common.cuh: best_choice).
// Two exchanges a class, not one: with int32 wraparound sum(take1) is not
// a function of the shards' cap totals (a prefix that wraps negative lets
// a later slot take pods), so n2 needs every shard's own sum.  In the pair
// each shard's int32 (the totals, then the take1 sums) reaches every shard
// through the exchange buffer (the shards of one device share it, one
// column a shard; the buffers of different devices meet through copies,
// ops/packer.py mesh_exchange_row), and the close of class g-1 rides the
// cap launch of class g, so a class costs two launches a shard.  The pair
// is a chain of launches, not of bytes or operations (PERF.md); across
// devices the shards cannot share a barrier, and that design (a persistent
// kernel a device, per-class flags in peer memory) waits for a machine of
// several cards (ROADMAP).
//
// Float rules as ffd_pack.cu: IEEE division (__fdiv_rn), no fast math, the
// usage update one __fmaf_rn.  int32 arithmetic wraps as XLA's does
// (computed in unsigned), division of negatives floors.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"  // ShardArgs, best_choice, window_take_sum, the wrapping
                       // int32 helpers, node_cap, block scans

namespace {

constexpr int kAssembleThreads = 256;
constexpr int kShardThreads = 1024;     // the most a shard launch takes

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
    const Choice ch = best_choice(a.rec, a.M, a.G, gp);
    const int c_star = ch.c_star, per = ch.per;
    unsigned lsum = 0;
    for (int d = 0; d < a.D; ++d)
      lsum += (unsigned)a.xchg[((size_t)a.G + gp) * a.D + d];
    const int n2 = wsub(a.cnt[gp], (int)lsum);
    const int nxt = *a.nxt;
    const int need = ch.ok ? floordiv(wsub(wadd(n2, per), 1), per) : 0;
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
