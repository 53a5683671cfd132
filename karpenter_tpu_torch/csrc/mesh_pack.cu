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
//   assemble_feasibility_kernel  grid (x, y, z), blocks of 4
//       warps: every tile (classes [g0, g1) x configs [c0, c1)) of the dense
//       feasibility mask that one launch writes, tile z of a table passed by
//       value, x a run of 512 configs, y a chunk of up to 32 classes;
//       written in place into one [G, C] replica or into a tile of its own.
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

constexpr int kShardThreads = 1024;     // the most a shard launch takes

// assemble_feasibility_kernel.  The function is a gather and a store:
// out[g, c] = type_ok[s, t_of[c]] & zone_ok[s, z_of[c]] & ct_ok[s, ct_of[c]],
// s = sig_of[g].  Its bound is the mask's bytes, about 0.8 us at Gp 320,
// Cp 8192; a byte a thread is issue-bound instead (a division, four
// dependent map loads and three gathers for each byte, 12 bytes of maps
// read per byte written).  Here:
// - a lane owns 16 consecutive configs of a row and writes them as one
//   16-byte store (byte stores only at a tile's ragged edges, or where the
//   row stride leaves a chunk unaligned);
// - the block copies its 512 configs' t_of / z_of / ct_of once (cp.async)
//   into shared memory, a 16-byte pad every 128 bytes so that the lanes'
//   16-byte reads of their own 16 configs meet no bank conflict; a lane
//   keeps them in registers for the whole chunk of classes;
// - a class's row is its signature's: warp 0 groups the chunk's classes
//   by signature (__match_any_sync), each distinct signature's 16 bytes
//   are gathered once from its type / zone / ct rows through the
//   read-only path (warp w takes the chunk's signatures w, w + 4, ...) and
//   stored for every class of its group;
// - 32-bit index math; only a row's address is widened.
// Measured on the H100 (PERF.md), staging the rows in shared memory was no
// faster than these gathers, and what is left is the launch, the
// prologue's round trip and the stores' drain, not the lookups.
constexpr int kAssembleWarps = 4;
constexpr int kAssembleBytes = 16;      // configs a lane: one uint4 store
constexpr int kAssembleMaxChunk = 32;   // classes a block: a lane of warp 0 each
constexpr int kAssembleMaxTiles = 32;   // tiles a launch (the table's size)
constexpr int kAssembleConfigs = 32 * kAssembleBytes;  // a block's configs
constexpr int kAssembleMapPitch = kAssembleConfigs + kAssembleConfigs / 8;  // padded

struct AssembleTile {
  uint8_t* out;  // the tile's byte (g0, c0); row g at out + (g - g0) * ld
  int g0, g1, c0, c1;
};

struct AssembleTiles {
  AssembleTile t[kAssembleMaxTiles];
};

__global__ void __launch_bounds__(32 * kAssembleWarps) assemble_feasibility_kernel(
    const uint8_t* __restrict__ type_ok, const uint8_t* __restrict__ zone_ok,
    const uint8_t* __restrict__ ct_ok, const int* __restrict__ sig_of,
    const int* __restrict__ t_of, const int* __restrict__ z_of,
    const int* __restrict__ ct_of, int T, int Z, int CT, int ld, int gc,
    const __grid_constant__ AssembleTiles tiles) {
  __shared__ int sig_at[kAssembleMaxChunk];           // row -> its signature
  __shared__ unsigned classes_of[kAssembleMaxChunk];  // row -> its classes (bit i: ga + i)
  __shared__ int n_rows;
  // the block's configs' t_of, z_of, ct_of: config j at j + j / 32 * 4
  __shared__ __align__(16) int maps[3][kAssembleMapPitch];
  const AssembleTile& tile = tiles.t[blockIdx.z];
  const int w = tile.c1 - tile.c0;
  const int shift = (int)((uintptr_t)tile.out & 15);  // chunks start 16-aligned
  const int nq = (w + shift + 15) >> 4;               // a row's chunks
  const int ga = tile.g0 + (int)blockIdx.y * gc;
  const int n = min(gc, tile.g1 - ga);
  if (w <= 0 || n <= 0 || (int)blockIdx.x * 32 >= nq) return;  // the whole block
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int j0 = ((int)blockIdx.x * 32 + lane) * kAssembleBytes - shift;
  const int tid = warp * 32 + lane, nt = 32 * kAssembleWarps;

  // The prologue in one round trip: the block's config maps go out as
  // cp.async copies, warp 0's signatures as loads beside them.
  const int jb = (int)blockIdx.x * kAssembleConfigs - shift;  // the block's first config
  for (int k = tid; k < kAssembleConfigs; k += nt) {
    const int j = jb + k, at = k + (k >> 5) * 4;
    if (j >= 0 && j < w) {
      cp_async(&maps[0][at], t_of + tile.c0 + j, 4);
      cp_async(&maps[1][at], z_of + tile.c0 + j, 4);
      cp_async(&maps[2][at], ct_of + tile.c0 + j, 4);
    } else {
      maps[0][at] = maps[1][at] = maps[2][at] = 0;
    }
  }
  if (warp == 0) {
    // A class's row of the mask is its signature's: the chunk's distinct
    // signatures are its rows, in the order of their first classes, and
    // each row is computed once and stored for every class of its group.
    const bool live = lane < n;
    const int s = live ? __ldg(sig_of + ga + lane) : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    const unsigned first = __ffs(peers) - 1;
    const bool leads = live && first == (unsigned)lane;
    const unsigned firsts = __ballot_sync(0xffffffffu, leads);
    if (leads) {
      const int r = __popc(firsts & ((1u << first) - 1u));
      sig_at[r] = s, classes_of[r] = peers;
    }
    if (lane == 0) n_rows = __popc(firsts);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (j0 >= w) return;  // every config of this lane lies past the tile

  int tj[kAssembleBytes], zj[kAssembleBytes], cj[kAssembleBytes];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int at = 16 * lane + 4 * k + (lane >> 1) * 4;
    const int4 t4 = *reinterpret_cast<const int4*>(&maps[0][at]);
    const int4 z4 = *reinterpret_cast<const int4*>(&maps[1][at]);
    const int4 c4 = *reinterpret_cast<const int4*>(&maps[2][at]);
    tj[4 * k] = t4.x, tj[4 * k + 1] = t4.y, tj[4 * k + 2] = t4.z, tj[4 * k + 3] = t4.w;
    zj[4 * k] = z4.x, zj[4 * k + 1] = z4.y, zj[4 * k + 2] = z4.z, zj[4 * k + 3] = z4.w;
    cj[4 * k] = c4.x, cj[4 * k + 1] = c4.y, cj[4 * k + 2] = c4.z, cj[4 * k + 3] = c4.w;
  }
  const bool whole = j0 >= 0 && j0 + kAssembleBytes <= w;
  const int nr = n_rows;
  for (int r = warp; r < nr; r += kAssembleWarps) {
    unsigned group = classes_of[r];
    const size_t s = (size_t)sig_at[r];
    const uint8_t* rt = type_ok + s * T;
    const uint8_t* rz = zone_ok + s * Z;
    const uint8_t* rc = ct_ok + s * CT;
    unsigned o[4];  // the lane's 16 bytes, any nonzero entry true
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int e = 4 * k + b;
        const unsigned x =
            (__ldg(rt + tj[e]) != 0) & (__ldg(rz + zj[e]) != 0) & (__ldg(rc + cj[e]) != 0);
        v |= x << (8 * b);
      }
      o[k] = v;
    }
    do {  // the row of each class of the group
      const int i = __ffs(group) - 1;
      group &= group - 1u;
      uint8_t* row = tile.out + (size_t)(ga + i - tile.g0) * ld;
      const uintptr_t at = (uintptr_t)row + j0;
      if (whole && (at & 15) == 0) {
        *reinterpret_cast<uint4*>(row + j0) = make_uint4(o[0], o[1], o[2], o[3]);
      } else if (whole && (at & 3) == 0) {
#pragma unroll
        for (int m = 0; m < 4; ++m) reinterpret_cast<unsigned*>(row + j0)[m] = o[m];
      } else {
#pragma unroll
        for (int b = 0; b < kAssembleBytes; ++b) {
          const int j = j0 + b;
          if (j >= 0 && j < w) row[j] = (uint8_t)(o[b >> 2] >> (8 * (b & 3)));
        }
      }
    } while (group);
  }
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

// Every tile of `bounds` ([n][4]: g0, g1, c0, c1) into its `outs[i]` (the
// tile's byte (g0, c0), rows `ld` bytes apart) in one launch of grid
// (gx, gy, n), `gc` classes a block (fused_packer.assemble_layout picks
// them).
int mesh_assemble_feasibility(const uint8_t* type_ok, const uint8_t* zone_ok,
                              const uint8_t* ct_ok, const int* sig_of,
                              const int* t_of, const int* z_of,
                              const int* ct_of, int T, int Z, int CT,
                              const int* bounds, uint8_t* const* outs, int n,
                              int ld, int gc, int gx, int gy, int device, void* stream) {
  if (n < 1 || n > kAssembleMaxTiles || gc < 1 || gc > kAssembleMaxChunk || gx < 1 || gy < 1)
    return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  AssembleTiles tiles{};
  for (int i = 0; i < n; ++i)
    tiles.t[i] = {outs[i], bounds[4 * i], bounds[4 * i + 1], bounds[4 * i + 2],
                  bounds[4 * i + 3]};
  assemble_feasibility_kernel<<<dim3(gx, gy, n), dim3(32, kAssembleWarps), 0,
                                (cudaStream_t)stream>>>(
      type_ok, zone_ok, ct_ok, sig_of, t_of, z_of, ct_of, T, Z, CT, ld, gc, tiles);
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
