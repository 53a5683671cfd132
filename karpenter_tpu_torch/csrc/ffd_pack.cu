// First-fit-decreasing (FFD) class scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pack_step` (karpenter_tpu/ops/pallas_packer.py,
// launched by `_pallas_pack` through pl.pallas_call) and computes the
// function of `_pack_core` (karpenter_tpu/ops/packer.py), which both JAX
// kernels share.  The plain PyTorch version is
// karpenter_tpu_torch/ops/packer.py:pack_reference; the Python wrappers are
// karpenter_tpu_torch/ops/fused_packer.py.
//
// Two launches per pack, choose_config and one of the three scans:
//   choose_config_kernel<kMulti, false>  grid (Gp,): one block per class
//                           picks the config a new node of that class opens
//                           on (first-index argmin of the objective's score
//                           over C); see "The choice" below.  Its shard
//                           mode <kMulti, true> is one tile of the device
//                           mesh's choice (parallel/mesh.py, mesh_pack.cu).
//   ffd_scan_kernel<M>      grid (1,): the resident scan.  One block walks
//                           the Gp classes in order with the whole slot
//                           state in shared memory; the wrapper takes it
//                           whenever that state fits a block.
//   ffd_scan_cluster_kernel<M>  grid (N,), one cluster of N = 2, 4 or 8
//                           CTAs: the resident scan with the slot state
//                           split over the shared memory of the cluster's
//                           CTAs, for slot counts whose state does not fit
//                           one block (see "The cluster-resident scan").
//   ffd_scan_global_kernel  grid (1,): the same scan with the slot state in
//                           the output buffers (device memory), for slot
//                           counts whose state does not fit a cluster.
// Each scan takes a batch axis (struct Batch): B what-if problems over one
// base, one block (resident, global: grid (1, B)) or one cluster (grid
// (N, B)) per element, for the consolidation verdicts, whose other steps
// are the verdict kernels and the population prologue (see "The
// consolidation verdicts" below).  The solve's scan is the one element B =
// 1 with no descriptor.  A batch runs first through
// ffd_scan_window_kernel<M>, grid (1, B): one CTA an element over a window
// of the first slots, where every element's frontier lies (see "The
// frontier-window scan"); the elements it cannot hold go on to the scan
// the shapes pick, whose blocks skip the others.  The admission fast path's score of one class
// against the live nodes is admit_kernel, grid (1,) (see "The admission
// score" below).
// The fleet pack (the multi-tenant solver service, replacing the JAX
// package's fleet_pack_kernel, a jitted vmap of _pack_core over B tenants
// in karpenter_tpu/ops/packer.py) is choose_config with a grid y of B and
// the picked scan in its third mode, kFleet: B problems of one shape, each
// array of each element its own (struct Batch), one block or one cluster
// an element, each the solo computation on its element's slice, so a
// tenant's row equals its solo pack bit for bit.  What bounds it is what
// bounds the solo scan, a chain of Gp dependent steps an element; at the
// service's B <= 16 most SMs stay idle (one CTA, or one cluster, an
// element), which a later design may spend.
// Per class each scan computes per-slot capacity, an exclusive int32 prefix
// over K, first-fit takes, an integer ceil-div window of new slots and the
// state updates.  Unlike the TPU kernel they gather feas[g, cfg[k]] directly and
// count in exact int32, so they need neither the signature admission table
// nor the f32 ceil-overshoot mask, and take any S, R and T.
//
// What bounds the scan: latency, not bytes or FLOPs.  Its inputs are
// ~1.3 MB of feasibility plus ~330 KB of take output at the bench shapes,
// but it is Gp dependent steps.  The global kernel pays per step ~10 block
// barriers (a chunked block scan and two block sums, each a full scan) and
// a chain of device-memory round trips: cfg[k] -> feas[g, cfg] ->
// alloc[cfg], the used / sigcnt read-modify-writes, take written and read
// back, the class scalars loaded after the step's first barrier.
//
// The resident kernel removes each of those:
//   A. Slot state in shared memory.  cfg, npods, used [R][KP], sigcnt
//      [S][KP] and a cached alloc row per open slot are loaded once and
//      written out once.  Thread t owns M consecutive slots, stored at
//      i * blockDim + t, so a warp touches 32 consecutive words.  A slot
//      that opens copies its config's alloc row into its cache (its config
//      never changes after), so the alloc gather leaves the step.  take is
//      stored once per slot and never read back.
//   B. Nothing the step needs is fetched during the step.  Feasibility
//      rows come through a ring of kRing rows, copied by cp.async kRing-1
//      classes ahead.  The class rows (req, alloc[c_star], cnt, maxper,
//      slot, c_star, new_ok, per and a flag word) come in tiles of kTile
//      classes, double-buffered: tile j+1 is loaded with plain loads at the
//      first step of tile j, so the c_star -> alloc gather waits once a
//      tile, not once a step.  (Per-class 4-byte cp.asyncs, with c_star
//      read a step ahead, cost more than the whole rest of the ring.)
//   C. One barrier per class step, __syncthreads_or.  The prefix is a
//      serial prefix over the thread's M slots, a warp shuffle scan, and
//      that barrier to exchange the warp totals (double-buffered by step
//      parity, so reuse needs no second barrier); every warp then scans
//      the totals itself.  The barrier also ORs "some cap >= 2^18": without
//      one, the exact sum of caps is below 2^31 and sum(take1) = min(n,
//      sum(cap)); with one, or n < 0, the wrapped sum is taken at a second
//      barrier, as _pack_core wraps.  sum(take2) = min(n2, opened * per)
//      when the window starts at a slot >= 0, else it is reduced and
//      written after the next step's barrier.  Both branches are
//      block-uniform.
// Two cuts of instructions: the caps loop visits only the axes the class
// requests (a bit mask in its flag word), and a slot that takes no pods
// skips used += 0 * req, npods += 0 and sigcnt += 0 where that is the
// identity bit for bit (see used_clean).
// What bounds the resident scan then is the latency of each warp's chain
// through a step, with two warps per scheduler at 256 threads: the capacity
// loads and IEEE divisions, the two shuffle scans around the barrier, the
// integer division of the window and the state updates.  Fewer warps with
// more slots each is slower, so the chain, not the issue rate, sets the
// pace.
//
// The choice (choose_config_kernel).  The function is Gp x Cp independent
// (class, config) pairs, each a capacity (an IEEE division per requested
// axis) and a score, then a first-index argmin per class; its bytes are
// the feasibility bytes plus one read of price, openable and the requested
// alloc axes, so at the bench shapes it is bound by neither bytes nor
// operations.  What a plain block loop over the configs spends its time
// on, and what this kernel does about each:
//   - the price ceiling, max(where(openable, price, 0)) + 1, takes its own
//     pass over price and openable: here it is reduced from the prices the
//     block loads for its pairs anyway (a warp reduce, one barrier, a warp
//     reduce);
//   - a loop that loads a feasibility byte, an openable byte, a price and
//     the alloc axes and divides before the next iteration's loads waits
//     on each load: here thread t owns the config quads (4 consecutive
//     configs) t, t + 256, ... and loads them a block of kQuads quads at a
//     time, as 16-byte price, 4-byte openable and 4-byte feasibility words,
//     plus the alloc values of a round of kRoundAxes requested axes, before
//     the block's first division; the next round's alloc loads are issued
//     before this round's divisions, and the next block's other loads
//     before this block's divisions;
//   - price / ceiling (JAX's price_norm) is divided only on the pairs that
//     score;
//   - thread 0 folding the warps' partials serially: after one barrier,
//     warp 0 reduces them with shuffles.
// The first block's capacities do not depend on the ceiling and are
// computed before its barrier.
// What bounds it then (measured on an H100, PERF.md): each thread's chain
// of IEEE divisions.  __fdiv_rn branches to a slow path, so a warp runs
// its divisions one after another, and the time is the divisions a thread
// owns over the warps the SMs hold.  Hence the small blocks (1 quad, 1
// axis a round: every register held for loads in flight costs resident
// warps) and the register cap of kChooseMinBlocks blocks a SM (the 320
// blocks of config 2 fit 3 to a SM: one wave on 132 SMs).
// The arithmetic per pair is node_cap's sequence, min with maxper, the
// objective's score, +inf where the pair is not feas && openable && cap >
// 0, and the (score, index) rule of a first-index argmin.  Where Cp is not
// a multiple of 4 or a word load would be misaligned, the same kernel
// reads each quad's configs one at a time (a grid-uniform branch).  Past 2
// blocks of configs the ceiling reads the later blocks' prices once more.

// Float rules (bit-equality with the JAX CPU reference): IEEE division
// (explicit __fdiv_rn / __fadd_rn; the library is built without
// --use_fast_math), `used + take * req` as ONE fused multiply-add
// (__fmaf_rn: XLA on a CPU with FMA contracts it, and the plain version's
// fma32 rounds once as well), first-index
// argmin, int32 wraparound where JAX wraps (prefix and sums in unsigned
// arithmetic).  Per-slot capacities are clamped to 2^30 before the int
// conversion; every use then takes the minimum with the class cap, which
// is at most 2^30, so the clamp changes no result.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"  // kBigF, the wrapping int32 helpers, node_cap, block scans

namespace {

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// The batch axis of a scan launch.  A scan kernel's mode (its template
// argument kMode) is one of three:
//   kSolo    the solve's scan: one element, grid y 1, no descriptor;
//   kWhatIf  B what-if problems over one base (the consolidation verdicts,
//            ops/fused_packer.py: ffd_scan_batch).  Element e scans the
//            base class rows perm[e][0..Gp) in that order, with the counts
//            cnt[e][g] (in the element's order) and the slots k with
//            rm[e][k] set removed: their config is -1 from the start, so
//            they take nothing, and the survivors keep their first-fit
//            order.  The choice (c_star, new_ok, per) is the base's, read
//            through the base row: a class's choice depends on its own row
//            and the price ceiling alone.  perm is read where a class row
//            or a feasibility row is loaded, never per slot.  done is set
//            where the frontier-window scan ran before this launch (see
//            "The frontier-window scan"): an element whose word is non-zero
//            was finished there, and its block (or its whole cluster: every
//            CTA reads the same word) returns before its first barrier;
//   kFleet   B independent problems of one shape (the multi-tenant
//            service's fleet pack, ops/fused_packer.py: fleet_pack): every
//            input, the choice included, is stacked element after element,
//            and element e's first free slot is next0[e].  A block (or a
//            cluster) offsets each input pointer to its element before
//            anything else (FLEET_ELEMENT) and then runs the solo scan.
// The solo instance folds every batch branch away.
constexpr int kSolo = 0, kWhatIf = 1, kFleet = 2;

struct Batch {
  const int* perm;    // [B][Gp] base rows (kWhatIf)
  const int* cnt;     // [B][Gp] counts (kWhatIf)
  const uint8_t* rm;  // [B][K] removed slots (kWhatIf)
  const int* done;    // [B] 1 where the window scan finished the element, or null (kWhatIf)
  const int* next0;   // [B] first free slot of each element (kFleet)
};

// Element e of a launch after the window scan, finished there already.
template <int kMode>
__device__ __forceinline__ bool finished(const Batch& bt, int e) {
  return kMode == kWhatIf && bt.done && __ldg(bt.done + e) != 0;
}

// A fleet launch's element e: every input pointer of a scan kernel moved
// to the element's slice of its stacked [B, ...] tensor (the per-element
// sizes follow from Gp, Cp, K, R and S), and next0 read from next0[e].
// A no-op in the other modes.
#define FLEET_ELEMENT(e)                                                    \
  if constexpr (kMode == kFleet) {                                          \
    const size_t eg = (size_t)(e) * Gp, ek = (size_t)(e) * K;               \
    req += eg * R;                                                          \
    cnt += eg;                                                              \
    maxper += eg;                                                           \
    slot += eg;                                                             \
    feas += eg * Cp;                                                        \
    alloc += (size_t)(e) * Cp * R;                                          \
    c_star += eg;                                                           \
    new_ok += eg;                                                           \
    per += eg;                                                              \
    used0 += ek * R;                                                        \
    cfg0 += ek;                                                             \
    npods0 += ek;                                                           \
    sig0 += ek * S;                                                         \
    next0 = __ldg(bt.next0 + (e));                                          \
  }

// One element's view of the batch.
struct Elem {
  const int* perm;
  const int* cnt;
  const uint8_t* rm;
  __device__ __forceinline__ int row(int g) const { return perm ? __ldg(perm + g) : g; }
  __device__ __forceinline__ int cfg_in(const int* cfg0, int k) const {
    return (rm && rm[k]) ? -1 : cfg0[k];
  }
};

// Element e of a what-if launch (every pointer of bt set), or, in the
// other modes, the element's own rows in order (null perm and rm, which
// the compiler folds away): the solo and fleet instances of each scan are
// the scan without a what-if axis.
template <int kMode>
__device__ __forceinline__ Elem elem_of(const Batch& bt, const int* cnt, int e,
                                        int Gp, int K) {
  Elem el{nullptr, cnt, nullptr};
  if (kMode == kWhatIf) {
    el.perm = bt.perm + (size_t)e * Gp;
    el.cnt = bt.cnt + (size_t)e * Gp;
    el.rm = bt.rm + (size_t)e * K;
  }
  return el;
}

// ---- the choice (see "The choice" above) ----------------------------------

constexpr int kChooseThreads = 256;
constexpr int kChooseWarps = kChooseThreads / 32;
constexpr int kChooseMinBlocks = 3;           // blocks a SM: caps registers
constexpr int kChooseShardMinBlocks = 1;      // a tile launch: fewer blocks than SMs
constexpr int kChooseRec = 4;                 // a tile's record: ops/packer.py MESH_REC
constexpr int kQuads = 1;                     // config quads a thread holds
constexpr int kPairs = 4 * kQuads;            // configs a thread holds
constexpr int kBlockConfigs = kChooseThreads * kPairs;  // 1024 a block
constexpr int kRoundAxes = 1;                 // alloc axes loaded per round

// Config slot n (< kPairs) of block b held by this thread.
__device__ __forceinline__ int choose_config_of(int b, int n) {
  return 4 * ((b * kQuads + (n >> 2)) * kChooseThreads + (int)threadIdx.x) +
         (n & 3);
}

// One block of configs as this thread holds it: prices, and per byte
// (config) 0xff where openable, resp. where feasible and openable.
struct ChooseBlock {
  float p[kPairs];
  unsigned open[kQuads];
  unsigned fo[kQuads];
};

__device__ __forceinline__ bool byte_set(unsigned w, int i) {
  return (w >> (8 * i)) & 1u;
}

// The block's class: its feasibility row and req row.
struct ChooseRow {
  const uint8_t* feas;
  const float* req;
  int Cp;
  bool vec;  // 4-wide loads: Cp % 4 == 0 and every word aligned
};

// Issues every load of block b: price, openable and the class's
// feasibility words (one 16-byte and two 4-byte loads a quad on the 4-wide
// path, byte loads otherwise).  Configs past Cp hold zeros.
__device__ __forceinline__ void load_block(ChooseBlock& B, int b,
                                           const ChooseRow& t,
                                           const float* __restrict__ price,
                                           const uint8_t* __restrict__ openable) {
  const int nquads = (t.Cp + 3) >> 2;
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int q = (b * kQuads + k) * kChooseThreads + (int)threadIdx.x;
    float4 p4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    unsigned ow = 0u, fw = 0u;
    if (q < nquads) {
      if (t.vec) {
        p4 = __ldg(reinterpret_cast<const float4*>(price) + q);
        ow = __ldg(reinterpret_cast<const unsigned*>(openable) + q);
        fw = __ldg(reinterpret_cast<const unsigned*>(t.feas) + q);
      } else {
        float pp[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * q + i;
          pp[i] = 0.0f;
          if (c < t.Cp) {
            pp[i] = __ldg(price + c);
            ow |= (unsigned)__ldg(openable + c) << (8 * i);
            fw |= (unsigned)__ldg(t.feas + c) << (8 * i);
          }
        }
        p4 = make_float4(pp[0], pp[1], pp[2], pp[3]);
      }
    }
    B.p[4 * k] = p4.x;
    B.p[4 * k + 1] = p4.y;
    B.p[4 * k + 2] = p4.z;
    B.p[4 * k + 3] = p4.w;
    B.open[k] = __vcmpne4(ow, 0u);
    B.fo[k] = __vcmpne4(fw, 0u) & B.open[k];
  }
}

// max(pm, where(openable, price, 0)) over the block's configs below Cp.
__device__ __forceinline__ float fold_ceiling(const ChooseBlock& B, int b,
                                              int Cp, float pm) {
#pragma unroll
  for (int n = 0; n < kPairs; ++n)
    if (choose_config_of(b, n) < Cp)
      pm = fmaxf(pm, byte_set(B.open[n >> 2], n & 3) ? B.p[n] : 0.0f);
  return pm;
}

// The axes the class requests, a warp-uniform cursor over chunks of 32
// axes: lane l holds the class's req value at axis base + l, `m` the
// chunk's requested axes not yet handed out.
struct AxisCursor {
  int base;
  unsigned m;
  float v;
};

// Up to kRoundAxes requested axes (ax -1 where none) and the class's req
// there (0 where none).
struct AxisRound {
  int ax[kRoundAxes];
  float rq[kRoundAxes];
};

__device__ __forceinline__ void cursor_load(AxisCursor& s, const ChooseRow& t,
                                            int R) {
  const int r = s.base + (int)(threadIdx.x & 31);
  s.v = r < R ? __ldg(t.req + r) : 0.0f;
  s.m = __ballot_sync(kFull, s.v > 0.0f);
}

__device__ __forceinline__ void cursor_start(AxisCursor& s, const ChooseRow& t,
                                             int R) {
  s.base = 0;
  cursor_load(s, t, R);
}

// Hands out the next round; false (and an empty round) when no requested
// axis is left.
__device__ __forceinline__ bool cursor_next(AxisCursor& s, AxisRound& rd,
                                            const ChooseRow& t, int R) {
  bool more = true;
  while (s.m == 0u) {
    s.base += 32;
    if (s.base >= R) {
      more = false;
      break;
    }
    cursor_load(s, t, R);
  }
#pragma unroll
  for (int kk = 0; kk < kRoundAxes; ++kk) {
    int bit = -1;
    if (more && s.m != 0u) {
      bit = __ffs(s.m) - 1;
      s.m &= s.m - 1u;
    }
    const float v = __shfl_sync(kFull, s.v, bit < 0 ? 0 : bit);
    rd.rq[kk] = bit < 0 ? 0.0f : v;
    rd.ax[kk] = bit < 0 ? -1 : s.base + bit;
  }
  return more;
}

// Issues the alloc loads of one round for block b, through the read-only
// path.
__device__ __forceinline__ void load_alloc(float (&a)[kRoundAxes][kPairs],
                                           const AxisRound& rd, int b,
                                           const float* __restrict__ alloc,
                                           int Cp, int R) {
#pragma unroll
  for (int kk = 0; kk < kRoundAxes; ++kk)
#pragma unroll
    for (int n = 0; n < kPairs; ++n) {
      const int c = choose_config_of(b, n);
      a[kk][n] = (rd.ax[kk] >= 0 && c < Cp)
                     ? __ldg(alloc + (size_t)c * R + rd.ax[kk])
                     : 0.0f;
    }
}

// node_cap's per-axis step for one round, on the pairs that are feasible
// and openable (the others score +inf whatever their capacity).
__device__ __forceinline__ void apply_round(float (&cap)[kPairs],
                                            const float (&a)[kRoundAxes][kPairs],
                                            const AxisRound& rd,
                                            const ChooseBlock& B) {
#pragma unroll
  for (int kk = 0; kk < kRoundAxes; ++kk) {
    const float q = rd.rq[kk];
    if (q > 0.0f) {
#pragma unroll
      for (int n = 0; n < kPairs; ++n)
        if (byte_set(B.fo[n >> 2], n & 3))
          cap[n] = fminf(cap[n], floorf(__fadd_rn(__fdiv_rn(a[kk][n], q), kNudge)));
    }
  }
}

// The block's capacities: round `rd` is loaded in `a`; each later round's
// alloc loads are issued before the current round's divisions.  Leaves in
// `cap` the pair's capacity as a float where the pair is feasible, openable
// and holds a pod, else 0 (`a` and `rd` are spent).
__device__ __forceinline__ void block_caps(float (&cap)[kPairs],
                                           float (&a)[kRoundAxes][kPairs],
                                           AxisRound& rd, AxisCursor& axes,
                                           const ChooseBlock& B, int b, int mp,
                                           const float* __restrict__ alloc,
                                           const ChooseRow& t, int R) {
#pragma unroll
  for (int n = 0; n < kPairs; ++n) cap[n] = kBigF;
  for (;;) {
    AxisRound rn;
    float an[kRoundAxes][kPairs];
    const bool more = cursor_next(axes, rn, t, R);
    if (more) load_alloc(an, rn, b, alloc, t.Cp, R);
    apply_round(cap, a, rd, B);
    if (!more) break;
    rd = rn;
#pragma unroll
    for (int kk = 0; kk < kRoundAxes; ++kk)
#pragma unroll
      for (int n = 0; n < kPairs; ++n) a[kk][n] = an[kk][n];
  }
#pragma unroll
  for (int n = 0; n < kPairs; ++n) {
    const int ci = min((int)fmaxf(cap[n], 0.0f), mp);
    cap[n] = (byte_set(B.fo[n >> 2], n & 3) && ci > 0) ? (float)ci : 0.0f;
  }
}

// Scores the block's pairs into the running (score, index) argmin.
__device__ __forceinline__ void block_scores(const float (&cap)[kPairs],
                                             const ChooseBlock& B, int b,
                                             int Cp, int objective,
                                             float price_ceil, float& best,
                                             int& bidx) {
#pragma unroll
  for (int n = 0; n < kPairs; ++n) {
    const int c = choose_config_of(b, n);
    if (c >= Cp) continue;
    const float p = B.p[n];
    const float capf = cap[n];
    float score = INFINITY;
    if (capf > 0.0f)
      score = objective == 1 ? __fdiv_rn(p, capf)
                             : __fadd_rn(-capf, __fdiv_rn(p, price_ceil));
    if (score < best || (score == best && c < bidx)) {
      best = score;
      bidx = c;
    }
  }
}

// One tile of the sharded pack's choice (parallel/mesh.py): the classes
// [g0, g0 + gridDim.x) over the configs [c0, c0 + Cp) of one model shard
// of a catalog of ldc configs, each block's record written to rec.
struct ChooseTile {
  int g0, c0, ldc;
  int* rec;  // [gridDim.x][kChooseRec]
};

// kMulti: Cp > kBlockConfigs, so the thread walks several blocks.
// kShard: a tile of the sharded pack (ChooseTile): the kernel sees the
// shard's Cp configs (price, openable, alloc and the feasibility row moved
// to c0, the rows ldc wide), takes the price ceiling over all ldc configs
// first, and writes each class's record (order-preserving score key,
// global index, cap, ok) where the solve's instances write (c_star,
// new_ok, per).  The least (key, index) over the shards' records is the
// first-index argmin over the catalog (the combine: ops/packer.py
// combine_choice, csrc/mesh_pack.cu).
template <bool kMulti, bool kShard>
__global__ void __launch_bounds__(kChooseThreads,
                                  kShard ? kChooseShardMinBlocks : kChooseMinBlocks)
    choose_config_kernel(
    const float* __restrict__ req, const int* __restrict__ maxper,
    const uint8_t* __restrict__ feas, const float* __restrict__ alloc,
    const float* __restrict__ price, const uint8_t* __restrict__ openable,
    int Cp, int R, int objective, int vec, int* __restrict__ c_star,
    int* __restrict__ new_ok, int* __restrict__ per, ChooseTile tile) {
  __shared__ float s_pm[kChooseWarps];
  __shared__ float s_val[kChooseWarps];
  __shared__ int s_idx[kChooseWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = kShard ? tile.g0 + (int)blockIdx.x : (int)blockIdx.x;
  // the ceiling's running max: -inf, or in a tile every config's
  // where(openable, price, 0) (max is exact in any order)
  float pm = -INFINITY;
  size_t row = (size_t)g * Cp;
  if constexpr (kShard) {
    for (int c = threadIdx.x; c < tile.ldc; c += kChooseThreads)
      pm = fmaxf(pm, __ldg(openable + c) ? __ldg(price + c) : 0.0f);
    price += tile.c0;
    openable += tile.c0;
    alloc += (size_t)tile.c0 * R;
    row = (size_t)g * tile.ldc + tile.c0;
  }
  if constexpr (!kShard) {  // a fleet launch's element blockIdx.y (grid y 1
                            // for one problem): its slice of each input and output
    const size_t e = blockIdx.y, eg = e * gridDim.x;
    req += eg * R;
    maxper += eg;
    feas += eg * Cp;
    alloc += e * Cp * R;
    price += e * Cp;
    openable += e * Cp;
    c_star += eg;
    new_ok += eg;
    per += eg;
  }
  const ChooseRow t{feas + row, req + (size_t)g * R, Cp, vec != 0};
  const int nb = (Cp + kBlockConfigs - 1) / kBlockConfigs;

  // ---- every load of the first block, then its alloc round -----------------
  ChooseBlock cur, nxt;
  load_block(cur, 0, t, price, openable);
  const int mp = __ldg(maxper + g);
  AxisCursor axes;
  AxisRound rd;
  float a[kRoundAxes][kPairs];
  cursor_start(axes, t, R);
  cursor_next(axes, rd, t, R);
  load_alloc(a, rd, 0, alloc, Cp, R);
  pm = fold_ceiling(cur, 0, Cp, pm);
  if constexpr (kMulti) {
    load_block(nxt, 1, t, price, openable);  // before this block's divisions
    pm = fold_ceiling(nxt, 1, Cp, pm);
    if constexpr (!kShard) {  // a tile has its ceiling already
      for (int b = 2; b < nb; ++b) {  // later blocks: a ceiling-only read
        ChooseBlock far;
        load_block(far, b, t, price, openable);
        pm = fold_ceiling(far, b, Cp, pm);
      }
    }
  }

  // ---- the first block's capacities, then the ceiling's one barrier -------
  float cap[kPairs];
  block_caps(cap, a, rd, axes, cur, 0, mp, alloc, t, R);
  if constexpr (kMulti) {
    cursor_start(axes, t, R);
    cursor_next(axes, rd, t, R);
    load_alloc(a, rd, 1, alloc, Cp, R);
  }
  for (int o = 16; o > 0; o >>= 1) pm = fmaxf(pm, __shfl_down_sync(kFull, pm, o));
  if (lane == 0) s_pm[warp] = pm;
  __syncthreads();
  float w = lane < kChooseWarps ? s_pm[lane] : -INFINITY;
  for (int o = 16; o > 0; o >>= 1) w = fmaxf(w, __shfl_xor_sync(kFull, w, o));
  const float price_ceil = __fadd_rn(w, 1.0f);

  float best = INFINITY;
  int bidx = 0x7fffffff;
  block_scores(cap, cur, 0, Cp, objective, price_ceil, best, bidx);
  if constexpr (kMulti) {
    for (int b = 1; b < nb; ++b) {
      cur = nxt;
      if (b + 1 < nb) load_block(nxt, b + 1, t, price, openable);
      block_caps(cap, a, rd, axes, cur, b, mp, alloc, t, R);
      if (b + 1 < nb) {
        cursor_start(axes, t, R);
        cursor_next(axes, rd, t, R);
        load_alloc(a, rd, b + 1, alloc, Cp, R);
      }
      block_scores(cap, cur, b, Cp, objective, price_ceil, best, bidx);
    }
  }

  // ---- the argmin through one barrier --------------------------------------
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
  if (warp == 0) {
    float v = lane < kChooseWarps ? s_val[lane] : INFINITY;
    int i = lane < kChooseWarps ? s_idx[lane] : 0x7fffffff;
    for (int o = kChooseWarps / 2; o > 0; o >>= 1) {
      const float os = __shfl_down_sync(kFull, v, o);
      const int oi = __shfl_down_sync(kFull, i, o);
      if (os < v || (os == v && oi < i)) {
        v = os;
        i = oi;
      }
    }
    if (lane == 0) {
      const int c = i;
      const int cap_c =
          min(node_cap(alloc + (size_t)c * R, nullptr, t.req, R), mp);
      const int ok = (t.feas[c] && openable[c] && cap_c > 0) ? 1 : 0;
      if constexpr (kShard) {
        int* r = tile.rec + (size_t)blockIdx.x * kChooseRec;
        r[0] = (int)score_key(v);
        r[1] = tile.c0 + c;
        r[2] = cap_c;
        r[3] = ok;
      } else {
        c_star[g] = c;
        new_ok[g] = ok;
        per[g] = max(cap_c, 1);
      }
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(1024) ffd_scan_global_kernel(
    const float* __restrict__ req, const int* __restrict__ cnt,
    const int* __restrict__ maxper, const int* __restrict__ slot,
    const uint8_t* __restrict__ feas, const float* __restrict__ alloc,
    const int* __restrict__ c_star, const int* __restrict__ new_ok,
    const int* __restrict__ per, const float* __restrict__ used0,
    const int* __restrict__ cfg0, const int* __restrict__ npods0,
    const int* __restrict__ sig0, int Gp, int Cp, int K, int R, int S,
    int next0, Batch bt, int* __restrict__ take, int* __restrict__ leftover,
    int* __restrict__ cfg, int* __restrict__ npods, float* __restrict__ used,
    int* __restrict__ sigcnt) {
  extern __shared__ float sreq[];  // [R]
  __shared__ unsigned sh[32];
  const int B = blockDim.x;
  const int e = kMode != kSolo ? blockIdx.y : 0;  // batch element
  if (finished<kMode>(bt, e)) return;
  FLEET_ELEMENT(e);
  const Elem el = elem_of<kMode>(bt, cnt, e, Gp, K);
  take += (size_t)e * Gp * K;
  leftover += (size_t)e * Gp;
  cfg += (size_t)e * K;
  npods += (size_t)e * K;
  used += (size_t)e * K * R;
  sigcnt += (size_t)e * S * K;

  // slot state starts from the prefill; slot k belongs to thread k % B in
  // every phase, so no barrier is needed between per-slot updates
  for (int k = threadIdx.x; k < K; k += B) {
    cfg[k] = el.cfg_in(cfg0, k);
    npods[k] = npods0[k];
    for (int r = 0; r < R; ++r) used[(size_t)k * R + r] = used0[(size_t)k * R + r];
    for (int s = 0; s < S; ++s) sigcnt[(size_t)s * K + k] = sig0[(size_t)s * K + k];
  }

  int nxt = next0;
  for (int g = 0; g < Gp; ++g) {
    const int hr = el.row(g);  // the class's base row
    for (int r = threadIdx.x; r < R; r += B) sreq[r] = req[(size_t)hr * R + r];
    __syncthreads();
    const int n = el.cnt[g], mp = maxper[hr], s = slot[hr];
    const uint8_t* feas_g = feas + (size_t)hr * Cp;
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
    const int pg = per[hr];
    const int need = new_ok[hr] ? floordiv(wadd(n2, pg - 1), pg) : 0;
    const int opened = min(need, K - nxt);
    const int cs = c_star[hr];
    unsigned t2_local = 0u;
    for (int k = threadIdx.x; k < K; k += B) {
      const bool win = k >= nxt && k < nxt + opened;
      const int t2 = win ? clip(wsub(n2, wmul(k - nxt, pg)), 0, pg) : 0;
      const int t = wadd(take_g[k], t2);
      take_g[k] = t;
      const float tf = (float)t;
      for (int r = 0; r < R; ++r) {
        float* u = used + (size_t)k * R + r;
        *u = __fmaf_rn(tf, sreq[r], *u);
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

// ---------------------------------------------------------------------------
// The resident scan
// ---------------------------------------------------------------------------

// The Python wrapper (ops/fused_packer.py: SCAN_RING, SCAN_TILE,
// SCAN_XCHG_BYTES, MAX_AXES, resident_layout) sizes the shared memory from
// these; the kernel traps if the bytes it is given do not cover its layout.
constexpr int kRing = 8;   // feasibility rows in flight
constexpr int kTile = 32;  // classes per tile of class rows
constexpr int kMaxR = 31;  // resource axes, at most: one flag bit each
// (verdict_rows takes any R: past ffd_verdict_max_axes its config pass
// reads its rows from device memory)
constexpr unsigned kFinite = 1u << 31;
constexpr int kXchgBytes = 2 * 32 * 4 + 32 * 4 + 2 * 32 * 4;

// A usage that the fused update of a zero take (finite request) does not
// leave as it is: -0.0 (0 * req + -0.0 is +0.0) or a NaN other than the
// card's canonical one (the update returns the canonical NaN).
__device__ __forceinline__ bool unclean(float f) {
  const unsigned u = __float_as_uint(f);
  return u == 0x80000000u || (isnan(f) && u != 0x7fffffffu);
}

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

// node_cap over a slot's state in shared memory, laid out [R][stride],
// for the axes set in `asked` (those with req > 0).
__device__ __forceinline__ int node_cap_sh(const float* alloc_k,
                                           const float* used_k, int stride,
                                           const float* req, unsigned asked) {
  float cap = kBigF;
  for (; asked; asked &= asked - 1) {
    const int r = __ffs(asked) - 1;
    const float rem = __fsub_rn(alloc_k[r * stride], used_k[r * stride]);
    cap = fminf(cap, floorf(__fadd_rn(__fdiv_rn(rem, req[r]), kNudge)));
  }
  return (int)fmaxf(cap, 0.0f);
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Wrapped int32 sum over the block at one barrier: warp sums into `sh`
// ([32]), then every warp adds them up.
__device__ __forceinline__ unsigned block_sum_once(unsigned v, unsigned* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? sh[lane] : 0u);
}

// Base row hr's feasibility row into a ring slot, in `chunk`-byte copies.
__device__ __forceinline__ void issue_feas(int hr, unsigned char* dst, int chunk,
                                           const uint8_t* feas, int Cp) {
  const uint8_t* row = feas + (size_t)hr * Cp;
  for (int i = threadIdx.x * chunk; i < Cp; i += blockDim.x * chunk)
    cp_async(dst + i, row + i, chunk);
}

// The class rows of classes [h0, h0 + kTile) into a tile, W = 2R + 7
// words a class: req[R], the alloc row of the config its new nodes open on,
// then cnt, maxper, slot, c_star, new_ok, per, and a word of flags: bit r
// set where req[r] > 0, kFinite where every req[r] is finite.  Plain
// loads: the tile is used kTile steps later, so only its own load waits.
// Class h of the element is its base row el.row(h); its count is
// el.cnt[h].
__device__ __forceinline__ void load_tile(
    int h0, int* tile, int Gp, int Cp, int R, const Elem& el, const float* req,
    const float* alloc, const int* maxper, const int* slot,
    const int* c_star, const int* new_ok, const int* per) {
  const int W = 2 * R + 7;
#pragma unroll 4
  for (int i = threadIdx.x; i < kTile * W; i += blockDim.x) {
    const int h = h0 + i / W, f = i % W;
    int v = 0;
    if (h < Gp) {
      const int hr = el.row(h);
      if (f < R) {
        v = __float_as_int(req[(size_t)hr * R + f]);
      } else if (f < 2 * R) {
        const int cs = c_star[hr];
        if (cs >= 0 && cs < Cp)  // else it never opens a node
          v = __float_as_int(alloc[(size_t)cs * R + (f - R)]);
      } else {
        switch (f - 2 * R) {
          case 0: v = el.cnt[h]; break;
          case 1: v = maxper[hr]; break;
          case 2: v = slot[hr]; break;
          case 3: v = c_star[hr]; break;
          case 4: v = new_ok[hr]; break;
          case 5: v = per[hr]; break;
          default: {
            unsigned flags = kFinite;
            for (int r = 0; r < R; ++r) {
              const float q = req[(size_t)hr * R + r];
              if (q > 0.0f) flags |= 1u << r;
              if (!isfinite(q)) flags &= ~kFinite;
            }
            v = (int)flags;
          }
        }
      }
    }
    tile[i] = v;
  }
}

// leftover[g] of a step whose opening window began before slot 0: its
// per-warp take-2 sums were left in `part` ([32]) for after the next barrier.
__device__ __forceinline__ void flush_leftover(const unsigned* part, int n2,
                                               int* out) {
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) == 0) {
    const unsigned v = warp_sum(lane < (int)(blockDim.x >> 5) ? part[lane] : 0u);
    if (lane == 0) *out = wsub(n2, (int)v);
  }
}

template <int M, int kMode>  // consecutive slots each thread owns; batch axis
__global__ void __launch_bounds__(1024) ffd_scan_kernel(
    const float* __restrict__ req, const int* __restrict__ cnt,
    const int* __restrict__ maxper, const int* __restrict__ slot,
    const uint8_t* __restrict__ feas, const float* __restrict__ alloc,
    const int* __restrict__ c_star, const int* __restrict__ new_ok,
    const int* __restrict__ per, const float* __restrict__ used0,
    const int* __restrict__ cfg0, const int* __restrict__ npods0,
    const int* __restrict__ sig0, int Gp, int Cp, int K, int R, int S,
    int next0, int smem_bytes, int chunk, Batch bt, int* __restrict__ take,
    int* __restrict__ leftover, int* __restrict__ cfg_out,
    int* __restrict__ npods_out, float* __restrict__ used_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, B = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = B >> 5;
  const int KP = M * B;  // slot i of thread t sits at i * B + t
  const int e = kMode != kSolo ? blockIdx.y : 0;  // batch element
  if (finished<kMode>(bt, e)) return;
  FLEET_ELEMENT(e);
  const Elem el = elem_of<kMode>(bt, cnt, e, Gp, K);
  take += (size_t)e * Gp * K;
  leftover += (size_t)e * Gp;
  cfg_out += (size_t)e * K;
  npods_out += (size_t)e * K;
  used_out += (size_t)e * K * R;

  // ring | class tiles | exchanges | slot state; each state array is
  // [R or S][KP]
  const int slot_bytes = (Cp + 15) & ~15;
  const int W = 2 * R + 7;  // words of a class row
  unsigned char* ring = smem;
  int* tiles = (int*)(smem + (size_t)kRing * slot_bytes);  // [2][kTile][W]
  size_t off = (size_t)kRing * slot_bytes + (size_t)8 * kTile * W;
  unsigned* xtot = (unsigned*)(smem + off);  // [2][32], by step parity
  unsigned* xsum = xtot + 2 * 32;             // [32]
  unsigned* xleft = xsum + 32;                // [2][32], by step parity
  off += kXchgBytes;
  float* s_used = (float*)(smem + off);
  float* s_alloc = s_used + (size_t)R * KP;  // alloc row of the slot's config
  int* s_cfg = (int*)(s_alloc + (size_t)R * KP);
  int* s_npods = s_cfg + KP;
  int* s_sig = s_npods + KP;
  off += (size_t)4 * KP * (2 * R + 2 + S);
  if (off > (size_t)smem_bytes) __trap();

  // ---- slot state in: the only gathers through cfg0 ------------------------
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int pos = i * B + tid, k = tid * M + i;
    const bool real = k < K;
    const int c = real ? el.cfg_in(cfg0, k) : -1;
    s_cfg[pos] = c;
    s_npods[pos] = real ? npods0[k] : 0;
    for (int r = 0; r < R; ++r) {
      s_used[r * KP + pos] = real ? used0[(size_t)k * R + r] : 0.0f;
      s_alloc[r * KP + pos] = (c >= 0 && c < Cp) ? alloc[(size_t)c * R + r] : 0.0f;
    }
    for (int s = 0; s < S; ++s) s_sig[s * KP + pos] = real ? sig0[(size_t)s * K + k] : 0;
  }
  // A slot that takes no pods may skip used += 0 * req when that is the
  // identity bit for bit: every req finite (a class flag) and no -0.0 or
  // non-canonical NaN in used, which holds for good if it holds for used0
  // (an add gives -0.0 only from two -0.0, and only canonical NaNs).
  bool odd = false;
  for (int i = tid; i < K * R; i += B) odd |= unclean(used0[i]);
  const bool used_clean = !__syncthreads_or(odd);

  // ---- classes 0 .. kRing-2 in flight and the first tile, before step 0 ---
  for (int h = 0; h < kRing - 1; ++h) {
    if (h < Gp) issue_feas(el.row(h), ring + (size_t)h * slot_bytes, chunk, feas, Cp);
    cp_async_commit();
  }
  load_tile(0, tiles, Gp, Cp, R, el, req, alloc, maxper, slot, c_star, new_ok, per);
  // the base row of the class whose feasibility row the next step issues,
  // loaded a step ahead of its use
  int ring_row = kMode == kWhatIf && Gp > kRing - 1 ? el.row(kRing - 1) : 0;
  cp_async_wait<kRing - 2>();
  __syncthreads();

  int nxt = next0;
  bool pend = false;  // a leftover waits for the next barrier
  int pend_g = 0, pend_n2 = 0;
  for (int g = 0; g < Gp; ++g) {
    const int p = g & 1;
    const unsigned char* row = ring + (size_t)(g % kRing) * slot_bytes;
    const float* creq =
        (const float*)(tiles + ((g / kTile) & 1) * kTile * W + (g % kTile) * W);
    const float* cacs = creq + R;
    const int* cint = (const int*)(creq + 2 * R);
    const int n = cint[0], mp = cint[1];
    int* sig_s = s_sig + cint[2] * KP;
    const unsigned flags = (unsigned)cint[6];
    const unsigned asked = flags & ~kFinite;
    const bool skip_idle = used_clean && (flags & kFinite);

    // ---- capacities and the serial prefix over the thread's slots ---------
    int cap[M];
    unsigned pre[M];
    unsigned run = 0u;
    bool big = false;  // some cap >= 2^18: the block's sum of caps may pass 2^31
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int pos = i * B + tid;
      const int c = s_cfg[pos];
      int cp = 0;
      if (c >= 0 && row[c]) {
        cp = node_cap_sh(s_alloc + pos, s_used + pos, KP, creq, asked);
        cp = min(cp, max(wsub(mp, sig_s[pos]), 0));
      }
      cap[i] = cp;
      pre[i] = run;
      run += (unsigned)cp;
      big |= cp >= (1 << 18);
    }
    unsigned incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) xtot[p * 32 + warp] = incl;
    {  // class g+kRing-1's row into the slot class g-1 left: every read of
       // it was before the previous step's barrier
      const int h = g + kRing - 1, hr = kMode == kWhatIf ? ring_row : h;
      if (kMode == kWhatIf && h + 1 < Gp) ring_row = el.row(h + 1);
      if (h < Gp) issue_feas(hr, ring + (size_t)(h % kRing) * slot_bytes, chunk, feas, Cp);
      cp_async_commit();
    }
    cp_async_wait<kRing - 2>();  // class g+1's row has landed
    // the step's barrier; with no cap >= 2^18 anywhere (at most 2 slots a
    // thread, 1024 threads) the exact sum of caps is below 2^31
    const bool wraps = __syncthreads_or(big);

    if (pend) {
      flush_leftover(xleft + (p ^ 1) * 32, pend_n2, leftover + pend_g);
      pend = false;
    }
    if (g % kTile == 0 && g + kTile < Gp)  // the next tile, into the other buffer
      load_tile(g + kTile, tiles + (((g / kTile) + 1) & 1) * kTile * W, Gp, Cp, R,
                el, req, alloc, maxper, slot, c_star, new_ok, per);

    // ---- this warp's offset and the block total from the warp totals ------
    unsigned w = lane < nw ? xtot[p * 32 + lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    const unsigned below = __shfl_sync(kFull, w, warp > 0 ? warp - 1 : 0);
    const unsigned total = __shfl_sync(kFull, w, 31);
    const unsigned base = (warp > 0 ? below : 0u) + incl - run;

    // ---- first fit in slot order ------------------------------------------
    int t1[M];
    unsigned t1sum = 0u;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      t1[i] = clip(wsub(n, (int)(base + pre[i])), 0, cap[i]);
      t1sum += (unsigned)t1[i];
    }
    // sum(take1) = min(n, sum(cap)) where no prefix wraps; else the wrapped
    // sum, as _pack_core takes it (a block-uniform branch)
    const int n2 = (n >= 0 && !wraps)
                       ? n - min(n, (int)total)
                       : wsub(n, (int)block_sum_once(t1sum, xsum));

    // ---- open new slots on the precomputed best config --------------------
    const int pg = cint[5], cs = cint[3];
    const int need = cint[4] ? floordiv(wadd(n2, wsub(pg, 1)), pg) : 0;
    const int opened = min(need, wsub(K, nxt));
    const int end = wadd(nxt, opened);
    int* take_g = take + (size_t)g * K;
    unsigned t2sum = 0u;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int pos = i * B + tid, k = tid * M + i;
      const bool win = k < K && k >= nxt && k < end;
      const int t2 = win ? clip(wsub(n2, wmul(wsub(k, nxt), pg)), 0, pg) : 0;
      const int t = wadd(t1[i], t2);
      if (k < K) take_g[k] = t;
      if (t != 0 || !skip_idle) {
        const float tf = (float)t;
        for (int r = 0; r < R; ++r) {
          float* u = s_used + r * KP + pos;
          *u = __fmaf_rn(tf, creq[r], *u);
        }
        s_npods[pos] = wadd(s_npods[pos], t);
        sig_s[pos] = wadd(sig_s[pos], t);
      }
      if (win) {
        s_cfg[pos] = cs;
        for (int r = 0; r < R; ++r) s_alloc[r * KP + pos] = cacs[r];
      }
      t2sum += (unsigned)t2;
    }
    if (nxt >= 0) {
      // the window is [nxt, nxt+opened) inside [0, K), so sum(take2) is
      // min(n2, opened*per) (opened > 0 implies n2 >= 1 and no wrap)
      if (tid == 0) {
        const long long placed =
            opened > 0 ? min((long long)n2, (long long)opened * pg) : 0ll;
        leftover[g] = n2 - (int)placed;
      }
    } else {
      const unsigned v = warp_sum(t2sum);
      if (lane == 0) xleft[p * 32 + warp] = v;
      pend = true;
      pend_g = g;
      pend_n2 = n2;
    }
    nxt = end;
  }
  if (pend) {
    __syncthreads();
    flush_leftover(xleft + ((Gp - 1) & 1) * 32, pend_n2, leftover + pend_g);
  }

  // ---- slot state out -------------------------------------------------------
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int pos = i * B + tid, k = tid * M + i;
    if (k < K) {
      cfg_out[k] = s_cfg[pos];
      npods_out[k] = s_npods[pos];
    }
  }
  for (int idx = tid; idx < K * R; idx += B) {
    const int k = idx / R, r = idx - k * R;
    used_out[idx] = s_used[r * KP + (k % M) * B + k / M];
  }
}

template <int M, int kMode>
int launch_resident(const float* req, const int* cnt, const int* maxper,
                    const int* slot, const uint8_t* feas, const float* alloc,
                    const int* c_star, const int* new_ok, const int* per,
                    const float* used0, const int* cfg0, const int* npods0,
                    const int* sig0, int Gp, int Cp, int K, int R, int S,
                    int next0, int threads, int smem_bytes, int chunk,
                    int nb, Batch bt, int* take, int* leftover, int* cfg,
                    int* npods, float* used, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      ffd_scan_kernel<M, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)e;
  }
  ffd_scan_kernel<M, kMode><<<dim3(1, nb), threads, smem_bytes, stream>>>(
      req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per, used0, cfg0,
      npods0, sig0, Gp, Cp, K, R, S, next0, smem_bytes, chunk, bt, take,
      leftover, cfg, npods, used);
  return (int)cudaGetLastError();
}

int scan_threads(int K) {
  int b = ((K + 31) / 32) * 32;
  return b < 32 ? 32 : (b > 1024 ? 1024 : b);
}

// ---------------------------------------------------------------------------
// The cluster-resident scan
// ---------------------------------------------------------------------------
//
// Replaces the same TPU kernel (karpenter_tpu/ops/pallas_packer.py:
// _pack_step) where the slot state does not fit one block: 4096 slots at
// R 6, S 2 need 262,144 bytes of state alone.  It is the resident scan
// above spread over a thread-block cluster of N = 2, 4 or 8 CTAs, which
// Hopper schedules on neighbouring SMs of one GPC and lets write each
// other's shared memory (DSMEM) and meet at one hardware barrier.
//   A. CTA rank r owns slots [r * KP, (r + 1) * KP), KP = M * blockDim; its
//      thread t owns M consecutive ones (global slot order: rank, thread,
//      slot), stored as in ffd_scan_kernel.  Loaded once, written once.
//   B. Each CTA keeps its own ring of whole feasibility rows (any slot may
//      hold any config) and its own double-buffered tiles of class rows
//      (issue_feas, load_tile), so nothing is fetched in the step.
//   C. One cluster barrier per class step.  Lane 31 of each warp stores its
//      inclusive warp total and a flag, "some cap of the warp >= wrap_guard",
//      into entry [parity][rank * nw + warp] of every CTA's exchange array
//      (st.shared::cluster).  After barrier.cluster.arrive.release / wait.
//      acquire every warp reads all N * nw entries: its base is the sum of
//      the entries before its own, the total the sum of all, `wraps` the OR
//      of all flags.  The ring's next cp.async is issued between arrive and
//      wait.  Parity double-buffering makes a second barrier unneeded: a CTA
//      reaches step g+2's stores only after every CTA has passed step g+1's
//      barrier, so after every read of step g.
// Every branch that reaches a cluster barrier (wraps, n2, opened, nxt,
// pend) is computed from cluster-wide values and the class row alone, so
// it is the same in every CTA.  The wrapped-sum path is a second cluster
// barrier with the warp sums exchanged the same way; take-2 sums of a
// window that starts below slot 0 go to rank 0's `xleft` and are reduced
// there after the next barrier.  The kernel starts and ends with a cluster
// barrier: no CTA stores into a peer that has not started, and none exits
// while a peer may still store into it.
// The wrap guard scales with K: with every cap below wrap_guard the exact
// sum of K caps is at most K * (wrap_guard - 1) < 2^31, which the wrapper
// (fused_packer.wrap_guard) makes hold.  The per-slot float arithmetic is
// the resident kernel's; what the cluster adds is integer (wrapping
// unsigned sums, associative, so the exchange order changes no bit).
// What bounds it: latency, as the resident scan -- per step one warp
// chain through the slots' capacities and one cluster exchange and
// barrier; the design keeps both to one each and moves every load off the
// step.  On an H100 the exchange and barrier take 0.8-0.9 us at every
// cluster size, about a third of a step at 4096 slots on 8 CTAs (PERF.md),
// so the wrapper takes the largest cluster that holds the slots: fewer
// slots a CTA shorten the chain and cost no more at the barrier.
constexpr int kMaxCluster = 8;
// exchange bytes per CTA of the cluster: xtot [2][32] uint2, xsum [32],
// xleft [2][32] (fused_packer.CLUSTER_XCHG_BYTES)
constexpr int kClusterXchgBytes = 2 * 32 * 8 + 32 * 4 + 2 * 32 * 4;

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

// Wrapped sum of part[0 .. count), in every lane of the calling warp.
__device__ __forceinline__ unsigned warp_sum_of(const unsigned* part, int count) {
  unsigned v = 0u;
  for (int j = threadIdx.x & 31; j < count; j += 32) v += part[j];
  return warp_sum(v);
}

template <int M, int kMode>  // consecutive slots each thread owns; batch axis
__global__ void __launch_bounds__(1024) ffd_scan_cluster_kernel(
    const float* __restrict__ req, const int* __restrict__ cnt,
    const int* __restrict__ maxper, const int* __restrict__ slot,
    const uint8_t* __restrict__ feas, const float* __restrict__ alloc,
    const int* __restrict__ c_star, const int* __restrict__ new_ok,
    const int* __restrict__ per, const float* __restrict__ used0,
    const int* __restrict__ cfg0, const int* __restrict__ npods0,
    const int* __restrict__ sig0, int Gp, int Cp, int K, int R, int S,
    int next0, int ctas, int smem_bytes, int chunk, int wrap_guard, Batch bt,
    int* __restrict__ take, int* __restrict__ leftover,
    int* __restrict__ cfg_out, int* __restrict__ npods_out,
    float* __restrict__ used_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, B = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = B >> 5;
  const int KP = M * B;  // this CTA's slots; slot i of thread t at i * B + t
  const int e = kMode != kSolo ? blockIdx.y : 0;  // batch element: the cluster's grid row
  if (finished<kMode>(bt, e)) return;  // every CTA of the cluster, before any DSMEM store
  FLEET_ELEMENT(e);
  const Elem el = elem_of<kMode>(bt, cnt, e, Gp, K);
  take += (size_t)e * Gp * K;
  leftover += (size_t)e * Gp;
  cfg_out += (size_t)e * K;
  npods_out += (size_t)e * K;
  used_out += (size_t)e * K * R;
  const int rank = (int)cluster_ctarank();
  const int k0 = rank * KP;        // this CTA's first slot
  const int XN = ctas * 32;        // exchange entries of one parity
  const int me = rank * nw + warp;  // this warp's exchange entry
  const int entries = ctas * nw;

  // ring | class tiles | exchanges | slot state, as in ffd_scan_kernel
  const int slot_bytes = (Cp + 15) & ~15;
  const int W = 2 * R + 7;
  unsigned char* ring = smem;
  int* tiles = (int*)(smem + (size_t)kRing * slot_bytes);  // [2][kTile][W]
  size_t off = (size_t)kRing * slot_bytes + (size_t)8 * kTile * W;
  uint2* xtot = (uint2*)(smem + off);           // [2][XN] (total, flag)
  unsigned* xsum = (unsigned*)(xtot + 2 * XN);  // [XN]
  unsigned* xleft = xsum + XN;                  // [2][XN], on rank 0
  off += (size_t)kClusterXchgBytes * ctas;
  float* s_used = (float*)(smem + off);
  float* s_alloc = s_used + (size_t)R * KP;
  int* s_cfg = (int*)(s_alloc + (size_t)R * KP);
  int* s_npods = s_cfg + KP;
  int* s_sig = s_npods + KP;
  off += (size_t)4 * KP * (2 * R + 2 + S);
  if (off > (size_t)smem_bytes || ctas > kMaxCluster ||
      (int)cluster_nctarank() != ctas)
    __trap();

  // ---- this CTA's slot state in -------------------------------------------
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int pos = i * B + tid, k = k0 + tid * M + i;
    const bool real = k < K;
    const int c = real ? el.cfg_in(cfg0, k) : -1;
    s_cfg[pos] = c;
    s_npods[pos] = real ? npods0[k] : 0;
    for (int r = 0; r < R; ++r) {
      s_used[r * KP + pos] = real ? used0[(size_t)k * R + r] : 0.0f;
      s_alloc[r * KP + pos] = (c >= 0 && c < Cp) ? alloc[(size_t)c * R + r] : 0.0f;
    }
    for (int s = 0; s < S; ++s) s_sig[s * KP + pos] = real ? sig0[(size_t)s * K + k] : 0;
  }
  // used_clean as in ffd_scan_kernel, over this CTA's own slots: it only
  // decides whether they skip used += 0 * req
  const int own = min(max(K - k0, 0), KP);
  bool odd = false;
  for (int i = tid; i < own * R; i += B) odd |= unclean(used0[(size_t)k0 * R + i]);
  const bool used_clean = !__syncthreads_or(odd);

  for (int h = 0; h < kRing - 1; ++h) {
    if (h < Gp) issue_feas(el.row(h), ring + (size_t)h * slot_bytes, chunk, feas, Cp);
    cp_async_commit();
  }
  load_tile(0, tiles, Gp, Cp, R, el, req, alloc, maxper, slot, c_star, new_ok, per);
  // the base row of the class whose feasibility row the next step issues,
  // loaded a step ahead of its use
  int ring_row = kMode == kWhatIf && Gp > kRing - 1 ? el.row(kRing - 1) : 0;
  cp_async_wait<kRing - 2>();
  cluster_sync();  // every CTA runs before the first DSMEM store

  int nxt = next0;
  bool pend = false;  // a leftover waits on rank 0 for the next barrier
  int pend_g = 0, pend_n2 = 0;
  for (int g = 0; g < Gp; ++g) {
    const int p = g & 1;
    const unsigned char* row = ring + (size_t)(g % kRing) * slot_bytes;
    const float* creq =
        (const float*)(tiles + ((g / kTile) & 1) * kTile * W + (g % kTile) * W);
    const float* cacs = creq + R;
    const int* cint = (const int*)(creq + 2 * R);
    const int n = cint[0], mp = cint[1];
    int* sig_s = s_sig + cint[2] * KP;
    const unsigned flags = (unsigned)cint[6];
    const unsigned asked = flags & ~kFinite;
    const bool skip_idle = used_clean && (flags & kFinite);

    // ---- capacities, the serial prefix over the thread's slots, the warp's
    int cap[M];
    unsigned pre[M];
    unsigned run = 0u;
    bool big = false;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int pos = i * B + tid;
      const int c = s_cfg[pos];
      int cp = 0;
      if (c >= 0 && row[c]) {
        cp = node_cap_sh(s_alloc + pos, s_used + pos, KP, creq, asked);
        cp = min(cp, max(wsub(mp, sig_s[pos]), 0));
      }
      cap[i] = cp;
      pre[i] = run;
      run += (unsigned)cp;
      big |= cp >= wrap_guard;
    }
    unsigned incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned wbig = __any_sync(kFull, big);
    if (lane == 31) {
      const uint2* dst = xtot + p * XN + me;
      for (int r = 0; r < ctas; ++r) st_cluster2(cluster_addr(dst, r), incl, wbig);
    }
    cp_async_wait<kRing - 3>();  // class g+1's row has landed
    cluster_arrive();
    {  // class g+kRing-1's row into the slot class g-1 left: every read of
       // it was before the previous step's barrier
      const int h = g + kRing - 1, hr = kMode == kWhatIf ? ring_row : h;
      if (kMode == kWhatIf && h + 1 < Gp) ring_row = el.row(h + 1);
      if (h < Gp) issue_feas(hr, ring + (size_t)(h % kRing) * slot_bytes, chunk, feas, Cp);
      cp_async_commit();
    }
    cluster_wait();

    if (pend) {
      if (rank == 0 && warp == 0) {
        const unsigned v = warp_sum_of(xleft + (p ^ 1) * XN, entries);
        if (lane == 0) leftover[pend_g] = wsub(pend_n2, (int)v);
      }
      pend = false;
    }
    if (g % kTile == 0 && g + kTile < Gp)  // the next tile, into the other buffer
      load_tile(g + kTile, tiles + (((g / kTile) + 1) & 1) * kTile * W, Gp, Cp, R,
                el, req, alloc, maxper, slot, c_star, new_ok, per);

    // ---- this warp's base, the cluster total and the wrap flag ------------
    unsigned below = 0u, sum = 0u, anyw = 0u;
    for (int j = lane; j < entries; j += 32) {
      const uint2 e = xtot[p * XN + j];
      sum += e.x;
      below += j < me ? e.x : 0u;
      anyw |= e.y;
    }
    const unsigned total = warp_sum(sum);
    const unsigned base = warp_sum(below) + incl - run;
    const bool wraps = __any_sync(kFull, anyw != 0u);

    // ---- first fit in slot order ------------------------------------------
    int t1[M];
    unsigned t1sum = 0u;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      t1[i] = clip(wsub(n, (int)(base + pre[i])), 0, cap[i]);
      t1sum += (unsigned)t1[i];
    }
    int n2;
    if (n >= 0 && !wraps) {
      n2 = n - min(n, (int)total);
    } else {  // the wrapped sum, at a second cluster barrier
      const unsigned v = warp_sum(t1sum);
      if (lane == 0)
        for (int r = 0; r < ctas; ++r) st_cluster(cluster_addr(xsum + me, r), v);
      cluster_sync();
      n2 = wsub(n, (int)warp_sum_of(xsum, entries));
    }

    // ---- open new slots on the precomputed best config; each CTA its own --
    const int pg = cint[5], cs = cint[3];
    const int need = cint[4] ? floordiv(wadd(n2, wsub(pg, 1)), pg) : 0;
    const int opened = min(need, wsub(K, nxt));
    const int end = wadd(nxt, opened);
    int* take_g = take + (size_t)g * K;
    unsigned t2sum = 0u;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int pos = i * B + tid, k = k0 + tid * M + i;
      const bool win = k < K && k >= nxt && k < end;
      const int t2 = win ? clip(wsub(n2, wmul(wsub(k, nxt), pg)), 0, pg) : 0;
      const int t = wadd(t1[i], t2);
      if (k < K) take_g[k] = t;
      if (t != 0 || !skip_idle) {
        const float tf = (float)t;
        for (int r = 0; r < R; ++r) {
          float* u = s_used + r * KP + pos;
          *u = __fmaf_rn(tf, creq[r], *u);
        }
        s_npods[pos] = wadd(s_npods[pos], t);
        sig_s[pos] = wadd(sig_s[pos], t);
      }
      if (win) {
        s_cfg[pos] = cs;
        for (int r = 0; r < R; ++r) s_alloc[r * KP + pos] = cacs[r];
      }
      t2sum += (unsigned)t2;
    }
    if (nxt >= 0) {  // closed form, as in ffd_scan_kernel
      if (rank == 0 && tid == 0) {
        const long long placed =
            opened > 0 ? min((long long)n2, (long long)opened * pg) : 0ll;
        leftover[g] = n2 - (int)placed;
      }
    } else {
      const unsigned v = warp_sum(t2sum);
      if (lane == 0) st_cluster(cluster_addr(xleft + p * XN + me, 0), v);
      pend = true;
      pend_g = g;
      pend_n2 = n2;
    }
    nxt = end;
  }
  cp_async_wait<0>();
  cluster_sync();  // every DSMEM store has landed; after this none is made
  if (pend && rank == 0 && warp == 0) {
    const unsigned v = warp_sum_of(xleft + ((Gp - 1) & 1) * XN, entries);
    if (lane == 0) leftover[pend_g] = wsub(pend_n2, (int)v);
  }

  // ---- this CTA's slot state out ------------------------------------------
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int pos = i * B + tid, k = k0 + tid * M + i;
    if (k < K) {
      cfg_out[k] = s_cfg[pos];
      npods_out[k] = s_npods[pos];
    }
  }
  for (int idx = tid; idx < own * R; idx += B) {
    const int kk = idx / R, r = idx - kk * R;
    used_out[(size_t)k0 * R + idx] = s_used[r * KP + (kk % M) * B + kk / M];
  }
}

// Returned where no cluster of the launch's shape fits the card at once
// (cudaOccupancyMaxActiveClusters gives 0).
constexpr int kClusterRefused = -2;

template <int M, int kMode>
int launch_cluster(const float* req, const int* cnt, const int* maxper,
                   const int* slot, const uint8_t* feas, const float* alloc,
                   const int* c_star, const int* new_ok, const int* per,
                   const float* used0, const int* cfg0, const int* npods0,
                   const int* sig0, int Gp, int Cp, int K, int R, int S,
                   int next0, int ctas, int threads, int smem_bytes, int chunk,
                   int wrap_guard, int nb, Batch bt, int* take, int* leftover,
                   int* cfg, int* npods, float* used, cudaStream_t stream) {
  const auto kernel = ffd_scan_cluster_kernel<M, kMode>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas, nb, 1);  // one cluster per element
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  if (clusters < 1) return kClusterRefused;
  e = cudaLaunchKernelEx(&config, kernel, req, cnt, maxper, slot, feas, alloc,
                         c_star, new_ok, per, used0, cfg0, npods0, sig0, Gp, Cp,
                         K, R, S, next0, ctas, smem_bytes, chunk, wrap_guard,
                         bt, take, leftover, cfg, npods, used);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The frontier-window scan
// ---------------------------------------------------------------------------
//
// Replaces, with the batched scans above, the scan half of the JAX
// package's removal_verdict_kernel / population_verdict_kernel
// (karpenter_tpu/ops/packer.py, a vmap of _pack_core) for the
// consolidation verdicts (ops/fused_packer.py: ffd_scan_batch).  Each
// element is one what-if over the removal base, whose slot count is padded
// to the worst case, one new node per universe pod (phase 9: n_live 77-151
// live slots in Kp 8192), while an element only ever touches its frontier:
// its live slots and the new slots opened so far.  Past the frontier a slot
// holds no config and takes nothing, and the fused update of a zero take
// leaves its usage as it is where the request is finite and the usage
// clean (`unclean`).  The batched cluster scan gave CTA rank r the slots
// [r * KP, (r + 1) * KP), so 7 of 8 CTAs held only such slots yet paid
// every step's exchange and cluster barrier, and 16 clusters fit the card.
// This kernel, grid (1, B), one CTA of kWinThreads an element:
//   A. The CTA holds a window of W = M * kWinThreads slots [0, W) in shared
//      memory, slot k on thread k % kWinThreads (round k / kWinThreads), so
//      the first slots, where the frontier lies, spread over every warp.
//      The wrapper picks W from (R, S, Cp) so that two CTAs fit a SM
//      (fused_packer.window_layout): the whole batch in one wave up to 264
//      elements.  Feasibility ring and class tiles as the resident scan.
//   B. A step works on the 32-slot entries before the frontier only (the
//      capacity pass; the update up to the frontier after the step's
//      openings, or every slot of the window for a class whose request is
//      not finite or where the window's usages are not clean).  The entry
//      totals (at most 32: W <= 1024) meet at the step's one barrier,
//      every warp scans them: one block barrier a step, no cluster.
//   C. The slots past the window are written once: their node_cfg (-1
//      where removed), node_pods and node_used (copied in 16-byte loads,
//      checked clean on the way) before the first step, their take zeros
//      with each step's row, in 16-byte streaming stores, off the step's
//      chain.  That tail is the kernel's bytes bound: take alone is B x Gp
//      x Kp x 4 bytes.
//   D. The element leaves the window, with no host sync, where its
//      frontier would pass W, or where the tail would change (a tail usage
//      not clean, a class whose request is not finite): it sets its word
//      of `done` to 0 and returns, and the launch that scan_kernel picks at
//      Kp runs next on the stream and takes it (Batch::done); every
//      element the window finishes sets its word to 1.
// The per-slot arithmetic is the resident scan's, in the same order, so
// the outputs are bit for bit those of ffd_scan_batch_reference (float
// rules above).  What bounds it: the take bytes at the batch's shapes, else
// the chain of Gp steps, each one capacity pass, one barrier and one
// update over the frontier's entries.
constexpr int kWinThreads = 256;
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kWinMinBlocks = 2;  // CTAs a SM the wrapper's W leaves room for
// the exchanges (fused_packer.WINDOW_XCHG_BYTES): the resident scan's, and
// the prologue's per-warp last live slot and flags [2][32]
constexpr int kWinXchgBytes = kXchgBytes + 2 * 32 * 4;

// Copies n floats, 16 bytes at a time where both ends are aligned, with
// streaming stores; true where one of them is not clean.
__device__ __forceinline__ bool copy_tail(const float* __restrict__ src,
                                          float* __restrict__ dst, size_t n) {
  bool odd = false;
  size_t i0 = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const size_t n4 = n / 4;
    for (size_t i = threadIdx.x; i < n4; i += blockDim.x) {
      const float4 v = __ldg(s4 + i);
      odd |= unclean(v.x) || unclean(v.y) || unclean(v.z) || unclean(v.w);
      __stcs(d4 + i, v);
    }
    i0 = n4 * 4;
  }
  for (size_t i = i0 + threadIdx.x; i < n; i += blockDim.x) {
    const float v = src[i];
    odd |= unclean(v);
    dst[i] = v;
  }
  return odd;
}

template <int M>  // rounds of kWinThreads slots: the window holds M * kWinThreads
__global__ void __launch_bounds__(kWinThreads, kWinMinBlocks) ffd_scan_window_kernel(
    const float* __restrict__ req, const int* __restrict__ maxper,
    const int* __restrict__ slot, const uint8_t* __restrict__ feas,
    const float* __restrict__ alloc, const int* __restrict__ c_star,
    const int* __restrict__ new_ok, const int* __restrict__ per,
    const float* __restrict__ used0, const int* __restrict__ cfg0,
    const int* __restrict__ npods0, const int* __restrict__ sig0, int Gp, int Cp,
    int K, int R, int S, int next0, int smem_bytes, int chunk, Batch bt,
    int* __restrict__ take, int* __restrict__ leftover, int* __restrict__ cfg_out,
    int* __restrict__ npods_out, float* __restrict__ used_out, int* __restrict__ done) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int T = kWinThreads, nw = kWinWarps, W = M * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.y;  // batch element
  const Elem el = elem_of<kWhatIf>(bt, nullptr, e, Gp, K);
  take += (size_t)e * Gp * K;
  leftover += (size_t)e * Gp;
  cfg_out += (size_t)e * K;
  npods_out += (size_t)e * K;
  used_out += (size_t)e * K * R;
  const int lim = min(K, W);  // the window's slots that exist

  // ring | class tiles | exchanges | window state, each [R or S][W]
  const int slot_bytes = (Cp + 15) & ~15;
  const int cw = 2 * R + 7;  // words of a class row
  unsigned char* ring = smem;
  int* tiles = (int*)(smem + (size_t)kRing * slot_bytes);  // [2][kTile][cw]
  size_t off = (size_t)kRing * slot_bytes + (size_t)8 * kTile * cw;
  unsigned* xtot = (unsigned*)(smem + off);  // [2][32] entry totals, by step parity
  unsigned* xsum = xtot + 2 * 32;             // [32]
  unsigned* xleft = xsum + 32;                // [2][32], by step parity
  int* xpro = (int*)(xleft + 2 * 32);         // [2][32] last live slot, flags
  off += kWinXchgBytes;
  float* s_used = (float*)(smem + off);
  float* s_alloc = s_used + (size_t)R * W;  // alloc row of the slot's config
  int* s_cfg = (int*)(s_alloc + (size_t)R * W);
  int* s_npods = s_cfg + W;
  int* s_sig = s_npods + W;
  off += (size_t)4 * W * (2 * R + 2 + S);
  if (off > (size_t)smem_bytes) __trap();

  // ---- classes 0 .. kRing-2 and the first tile in flight -------------------
  for (int h = 0; h < kRing - 1; ++h) {
    if (h < Gp) issue_feas(el.row(h), ring + (size_t)h * slot_bytes, chunk, feas, Cp);
    cp_async_commit();
  }
  load_tile(0, tiles, Gp, Cp, R, el, req, alloc, maxper, slot, c_star, new_ok, per);
  int ring_row = Gp > kRing - 1 ? el.row(kRing - 1) : 0;

  // ---- the window's slot state in ------------------------------------------
  int last = -1;     // the last slot with a config (rm applied)
  bool odd = false;  // a window usage not clean
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int k = i * T + tid;
    const bool real = k < K;
    const int c = real ? el.cfg_in(cfg0, k) : -1;
    if (c >= 0) last = k;
    s_cfg[k] = c;
    s_npods[k] = real ? npods0[k] : 0;
    for (int r = 0; r < R; ++r) {
      const float u = real ? used0[(size_t)k * R + r] : 0.0f;
      odd |= unclean(u);
      s_used[r * W + k] = u;
      s_alloc[r * W + k] = (c >= 0 && c < Cp) ? alloc[(size_t)c * R + r] : 0.0f;
    }
    for (int s = 0; s < S; ++s) s_sig[s * W + k] = real ? sig0[(size_t)s * K + k] : 0;
  }
  // ---- the tail past the window, written once ------------------------------
  bool moved = false;  // the tail would change: a usage not clean, a request not finite
  if (K > W) {
    for (int k = W + tid; k < K; k += T) {
      const int c = el.cfg_in(cfg0, k);
      if (c >= 0) last = k;
      cfg_out[k] = c;
      npods_out[k] = npods0[k];
    }
    moved = copy_tail(used0 + (size_t)W * R, used_out + (size_t)W * R, (size_t)(K - W) * R);
    for (int i = tid; i < Gp * R; i += T) {
      const int g = i / R;
      moved |= !isfinite(req[(size_t)el.row(g) * R + (i - g * R)]);
    }
  }
  last = __reduce_max_sync(kFull, last);
  const unsigned wflags = __reduce_or_sync(kFull, (odd ? 1u : 0u) | (moved ? 2u : 0u));
  if (lane == 0) {
    xpro[warp] = last;
    xpro[32 + warp] = (int)wflags;
  }
  cp_async_wait<kRing - 2>();
  __syncthreads();
  unsigned flags_all = 0u;
  for (int w = 0; w < nw; ++w) {
    last = max(last, xpro[w]);
    flags_all |= (unsigned)xpro[32 + w];
  }
  const bool window_clean = !(flags_all & 1u);
  int front = max(next0, last + 1);  // the frontier: at most K, and at most W to stay
  if (K > W && (front > W || (flags_all & 2u))) {  // block-uniform
    if (tid == 0) done[e] = 0;
    cp_async_wait<0>();
    return;
  }
  const bool vec = (K & 3) == 0 && (reinterpret_cast<uintptr_t>(take) & 15) == 0;

  int nxt = next0;
  bool pend = false;  // a leftover waits for the next barrier
  int pend_g = 0, pend_n2 = 0;
  for (int g = 0; g < Gp; ++g) {
    const int p = g & 1;
    const unsigned char* row = ring + (size_t)(g % kRing) * slot_bytes;
    const float* creq =
        (const float*)(tiles + ((g / kTile) & 1) * kTile * cw + (g % kTile) * cw);
    const float* cacs = creq + R;
    const int* cint = (const int*)(creq + 2 * R);
    const int n = cint[0], mp = cint[1];
    int* sig_s = s_sig + cint[2] * W;
    const unsigned flags = (unsigned)cint[6];
    const unsigned asked = flags & ~kFinite;
    const bool skip_idle = window_clean && (flags & kFinite);
    const int act = (front + 31) >> 5;  // entries (32 slots) before the frontier

    // ---- capacities of the entries before the frontier, warp scans ---------
    int cap[M];
    unsigned ex[M];  // exclusive prefix within the entry
    bool big = false;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int j = i * nw + warp;  // this warp's entry of round i: slots [32j, 32j + 32)
      cap[i] = 0;
      ex[i] = 0u;
      if (j < act) {  // warp-uniform
        const int k = i * T + tid;
        const int c = s_cfg[k];
        int cp = 0;
        if (c >= 0 && row[c]) {
          cp = node_cap_sh(s_alloc + k, s_used + k, W, creq, asked);
          cp = min(cp, max(wsub(mp, sig_s[k]), 0));
        }
        unsigned incl = (unsigned)cp;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        if (lane == 31) xtot[p * 32 + j] = incl;
        cap[i] = cp;
        ex[i] = incl - (unsigned)cp;
        big |= cp >= (1 << 18);
      }
    }
    {  // class g+kRing-1's row into the slot class g-1 left: every read of
       // it was before the previous step's barrier
      const int h = g + kRing - 1, hr = ring_row;
      if (h + 1 < Gp) ring_row = el.row(h + 1);
      if (h < Gp) issue_feas(hr, ring + (size_t)(h % kRing) * slot_bytes, chunk, feas, Cp);
      cp_async_commit();
    }
    cp_async_wait<kRing - 2>();  // class g+1's row has landed
    // the step's barrier; with no cap >= 2^18 (at most 1024 slots) the
    // exact sum of caps is below 2^31
    const bool wraps = __syncthreads_or(big);

    if (pend) {
      flush_leftover(xleft + (p ^ 1) * 32, pend_n2, leftover + pend_g);
      pend = false;
    }
    if (g % kTile == 0 && g + kTile < Gp)  // the next tile, into the other buffer
      load_tile(g + kTile, tiles + (((g / kTile) + 1) & 1) * kTile * cw, Gp, Cp, R,
                el, req, alloc, maxper, slot, c_star, new_ok, per);

    // ---- the entries' bases and the total, first fit in slot order ---------
    unsigned w = lane < act ? xtot[p * 32 + lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    const unsigned total = __shfl_sync(kFull, w, 31);
    int t1[M];
    unsigned t1sum = 0u;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int j = i * nw + warp;
      t1[i] = 0;
      if (j < act) {  // warp-uniform
        const unsigned below = __shfl_sync(kFull, w, j > 0 ? j - 1 : 0);
        t1[i] = clip(wsub(n, (int)((j > 0 ? below : 0u) + ex[i])), 0, cap[i]);
        t1sum += (unsigned)t1[i];
      }
    }
    // sum(take1) = min(n, sum(cap)) where no prefix wraps; else the wrapped
    // sum, as _pack_core takes it (a block-uniform branch)
    const int n2 = (n >= 0 && !wraps)
                       ? n - min(n, (int)total)
                       : wsub(n, (int)block_sum_once(t1sum, xsum));

    // ---- open new slots on the precomputed best config --------------------
    const int pg = cint[5], cs = cint[3];
    const int need = cint[4] ? floordiv(wadd(n2, wsub(pg, 1)), pg) : 0;
    const int opened = min(need, wsub(K, nxt));
    const int end = wadd(nxt, opened);
    const int front2 = max(front, end);
    if (front2 > W) {  // block-uniform: the element leaves the window
      if (tid == 0) done[e] = 0;
      cp_async_wait<0>();
      return;
    }
    const int uact = ((skip_idle ? front2 : lim) + 31) >> 5;  // entries updated
    int* take_g = take + (size_t)g * K;
    unsigned t2sum = 0u;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int j = i * nw + warp;
      if (j < uact) {
        const int k = i * T + tid;
        const bool win = k < K && k >= nxt && k < end;
        const int t2 = win ? clip(wsub(n2, wmul(wsub(k, nxt), pg)), 0, pg) : 0;
        const int t = wadd(t1[i], t2);
        if (k < K) take_g[k] = t;
        if (t != 0 || !skip_idle) {
          const float tf = (float)t;
          for (int r = 0; r < R; ++r) {
            float* u = s_used + r * W + k;
            *u = __fmaf_rn(tf, creq[r], *u);
          }
          s_npods[k] = wadd(s_npods[k], t);
          sig_s[k] = wadd(sig_s[k], t);
        }
        if (win) {
          s_cfg[k] = cs;
          for (int r = 0; r < R; ++r) s_alloc[r * W + k] = cacs[r];
        }
        t2sum += (unsigned)t2;
      }
    }
    // the row's slots past the updated entries take nothing
    const int z0 = min(uact * 32, K);
    if (vec) {
      int4* row4 = reinterpret_cast<int4*>(take_g);
      for (int q = (z0 >> 2) + tid; q < (K >> 2); q += T) __stcs(row4 + q, make_int4(0, 0, 0, 0));
    } else {
      for (int k = z0 + tid; k < K; k += T) take_g[k] = 0;
    }
    if (nxt >= 0) {  // closed form, as in ffd_scan_kernel
      if (tid == 0) {
        const long long placed =
            opened > 0 ? min((long long)n2, (long long)opened * pg) : 0ll;
        leftover[g] = n2 - (int)placed;
      }
    } else {
      const unsigned v = warp_sum(t2sum);
      if (lane == 0) xleft[p * 32 + warp] = v;
      pend = true;
      pend_g = g;
      pend_n2 = n2;
    }
    nxt = end;
    front = front2;
  }
  if (pend) {
    __syncthreads();
    flush_leftover(xleft + ((Gp - 1) & 1) * 32, pend_n2, leftover + pend_g);
  }

  // ---- the window's slot state out -----------------------------------------
  cp_async_wait<0>();
  __syncthreads();
  for (int k = tid; k < lim; k += T) {
    cfg_out[k] = s_cfg[k];
    npods_out[k] = s_npods[k];
  }
  for (int idx = tid; idx < lim * R; idx += T) {
    const int k = idx / R;
    used_out[idx] = s_used[(idx - k * R) * W + k];
  }
  if (tid == 0) done[e] = 1;
}

template <int M>
int launch_window(const float* req, const int* maxper, const int* slot,
                  const uint8_t* feas, const float* alloc, const int* c_star,
                  const int* new_ok, const int* per, const float* used0,
                  const int* cfg0, const int* npods0, const int* sig0, int Gp,
                  int Cp, int K, int R, int S, int next0, int smem_bytes,
                  int chunk, int nb, Batch bt, int* take, int* leftover, int* cfg,
                  int* npods, float* used, int* done, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      ffd_scan_window_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  ffd_scan_window_kernel<M><<<dim3(1, nb), kWinThreads, smem_bytes, stream>>>(
      req, maxper, slot, feas, alloc, c_star, new_ok, per, used0, cfg0, npods0, sig0,
      Gp, Cp, K, R, S, next0, smem_bytes, chunk, bt, take, leftover, cfg, npods, used,
      done);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The consolidation verdicts
// ---------------------------------------------------------------------------
//
// The JAX package answers B what-if removals with two jitted XLA functions,
// removal_verdict_kernel and population_verdict_kernel
// (karpenter_tpu/ops/packer.py), each _pack_core vmapped over B problems
// plus a per-element epilogue, _verdict_row.  Here the B scans are one
// launch of the scans above with the batch axis (Batch), and the rest is
// four small kernels:
//   verdict_summary_kernel  grid (B,): one block per element reads its scan
//                           outputs and writes a record to scratch: the
//                           leftover sum, the new slots' count and
//                           non-donors, c_star and its (pool, zone, ct)
//                           key, k_star's usage and the new slots' load
//                           [R] each, and as bit words over base classes
//                           the classes on k_star and on any new slot;
//   verdict_configs_kernel  grid (ceil(Cp / kCfgTile), ceil(B / group)):
//                           each thread loads one config once and tests it
//                           against the `group` elements (at most kGroup)
//                           of its block; the masked price's first-index
//                           argmin per element is reduced in the warp and
//                           combined across blocks by one 64-bit atomicMin,
//                           `hold` by atomicOr;
//   verdict_write_kernel    grid (ceil(B / 256),): the six-value rows;
//   population_pairs_kernel grid (P,): one block per removal mask derives
//                           its counts, removed slots and FFD class order,
//                           the batched scan's inputs.
// What bounds them is latency: each is a few dependent passes.  A block
// per element walking every config would reload the whole config table
// for each element, a chain of loads per config; the config pass reads
// each config once per group of elements, every load issued before its
// first use, and tests the group's records from shared memory as mask
// words (bit el: element e0 + el), skipping the tests no element of the
// warp needs.  The prologue spreads its (candidate, class) pairs over the
// threads, one load of each tensor a selected pair.

constexpr int kSummaryThreads = 256;
constexpr int kSummaryWarps = kSummaryThreads / 32;
constexpr int kSummaryMinBlocks = 4;  // a SM's summary blocks: 132 x 4 hold B 512 at once
constexpr int kCfgTile = 256;  // configs of a config-pass block, one a thread
constexpr int kCfgWarps = kCfgTile / 32;
constexpr int kGroup = 32;     // the most elements of a config-pass block: a mask word
// config-pass blocks a SM, in its launch bounds: with the thread count alone
// ptxas capped the instance that reads its rows from device memory at 32
// registers and spilled; this lifts the cap to 64
constexpr int kCfgMinBlocks = 4;
constexpr int kWriteThreads = 256;
constexpr int kRecInts = 8;    // lo_units, new_count, non_donors, cs, pool, zone, ct, 0
constexpr float kFitSlack = 1e-6f;   // `used <= alloc + 1e-6`
constexpr int kVerdictWidth = 6;     // ops/packer.py: RV_WIDTH
constexpr unsigned kInfKey = 0xff800000u;  // price_key(+inf)

// The order-preserving map of a float onto uint32 (a < b as floats iff
// key(a) < key(b)), with -0.0 taken as +0.0 so the two tie as they compare
// equal; the first-index argmin of (key << 32 | config) is then a plain
// 64-bit min.
__device__ __forceinline__ unsigned price_key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The scratch of verdict_rows (one allocation, laid out by verdict_scratch).
struct VerdictScratch {
  unsigned long long* best;  // [B] (price_key << 32 | config): the argmin cell
  int* rec;                  // [B][kRecInts]
  float* load;               // [B][2R]: k_star's usage, then the new slots' load
  unsigned* flags;           // [B][2W]: on k_star, then on a new slot (bit b: base class b)
  unsigned* hold;            // [B]
};

inline uintptr_t up16(uintptr_t n) { return (n + 15) & ~(uintptr_t)15; }

// The scratch at `base` for B elements of G classes and R axes; `bytes`
// gets its size.
inline VerdictScratch verdict_scratch(void* base, int B, int G, int R, size_t* bytes) {
  const uintptr_t W = (G + 31) / 32, b = (uintptr_t)B;
  VerdictScratch s;
  uintptr_t o = (uintptr_t)base;
  s.best = (unsigned long long*)o;
  o = up16(o + 8 * b);
  s.rec = (int*)o;
  o = up16(o + 4 * kRecInts * b);
  s.load = (float*)o;
  o = up16(o + 4 * 2 * (uintptr_t)R * b);
  s.flags = (unsigned*)o;
  o = up16(o + 4 * 2 * W * b);
  s.hold = (unsigned*)o;
  o = up16(o + 4 * b);
  if (bytes) *bytes = (size_t)(o - (uintptr_t)base);
  return s;
}

// Sets base class b's bit in `words` (b outside [0, G) names no class).
__device__ __forceinline__ void set_class(unsigned* words, int b, int G) {
  if ((unsigned)b < (unsigned)G) atomicOr(words + (b >> 5), 1u << (b & 31));
}

// Dynamic shared memory of a summary block: the element's base rows [Gp],
// the new-slot bit mask [ceil(K / 32)], the two class flag masks
// [ceil(Gp / 32)] each, then compactable of each base class as bytes [Gp].
__host__ __device__ inline size_t summary_smem(int Gp, int K) {
  return (size_t)4 * (Gp + (K + 31) / 32 + 2 * ((Gp + 31) / 32)) + (size_t)Gp;
}

// _verdict_row's epilogue over element e's scan outputs (the batched
// layout of ffd_scan_batch), up to the configs.  Pass 1: the leftover sum,
// the base rows, the compactable flags (by base class) and each thread's
// first kSlots slots' pod counts, all loaded before the first barrier.
// Pass 2, threads over the slots [next0, K): the new slots (node_pods > 0;
// newmask is false below next0) as a bit mask, their count, the first
// (k_star, else 0: argmax of an all-false mask), the classes on each and
// the non-donors.  Pass 3: the classes on k_star; per axis a warp reads
// k_star's usage and sums new_load in ascending slot order, the usage of
// four words (32 slots each) of the new-slot mask loaded at once.  All
// counts int32, as JAX's.  feas_p[g] = feas[perm[g]], so a permuted class
// g's flag is bit perm[g] of the record's words.  Its launch bounds name
// kSummaryMinBlocks: with the thread count alone ptxas capped it at 32
// registers (a full SM's worth of blocks) and spilled.
__global__ void __launch_bounds__(kSummaryThreads, kSummaryMinBlocks) verdict_summary_kernel(
    const int* __restrict__ take, const int* __restrict__ leftover,
    const int* __restrict__ node_cfg, const int* __restrict__ node_pods,
    const float* __restrict__ node_used, const int* __restrict__ perm_b,
    const int* __restrict__ pool_id, const int* __restrict__ zone_id,
    const int* __restrict__ ct_id, const uint8_t* __restrict__ compactable,
    int Gp, int K, int R, int next0, VerdictScratch vs) {
  extern __shared__ __align__(16) unsigned char vsm[];
  __shared__ unsigned s_sum[3][kSummaryWarps];  // leftover, new slots, non-donors
  __shared__ int s_first[kSummaryWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.x;
  const int nwords = (K + 31) >> 5, W = (Gp + 31) >> 5;
  take += (size_t)e * Gp * K;
  leftover += (size_t)e * Gp;
  node_cfg += (size_t)e * K;
  node_pods += (size_t)e * K;
  node_used += (size_t)e * K * R;
  perm_b += (size_t)e * Gp;
  int* s_perm = (int*)vsm;                          // [Gp]
  unsigned* s_new = (unsigned*)(s_perm + Gp);       // [nwords]
  unsigned* s_onnew = s_new + nwords;               // [W]
  unsigned* s_onany = s_onnew + W;                  // [W]
  uint8_t* s_comp = (uint8_t*)(s_onany + W);        // [Gp], by base class

  // ---- 1. the leftover sum (wrapping, as int32); masks cleared; this
  // thread's first kSlots slots' pod counts loaded before the barrier -------
  constexpr int T = kSummaryThreads, kSlots = 8;
  int pods[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int k = next0 + tid + i * T;
    pods[i] = k < K ? node_pods[k] : 0;
  }
  unsigned lsum = 0u;
  for (int g = tid; g < Gp; g += T) {
    lsum += (unsigned)leftover[g];
    s_perm[g] = perm_b[g];
    s_comp[g] = compactable[g];
  }
  for (int w = tid; w < nwords; w += T) s_new[w] = 0u;
  for (int w = tid; w < 2 * W; w += T) s_onnew[w] = 0u;  // and s_onany
  __syncthreads();

  // ---- 2. the new slots: the mask, count and first, the classes on each
  // (eight classes' take loaded at once), the non-donors --------------------
  unsigned cnt = 0u, nondonor = 0u;
  int first = 0x7fffffff;
  for (int k0 = next0 + tid; k0 < K; k0 += kSlots * T) {
    if (k0 != next0 + tid) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i)
        pods[i] = k0 + i * T < K ? node_pods[k0 + i * T] : 0;
    }
    unsigned m = 0u, big = 0u;  // bit i: slot k0 + i * T is new; holds > 8 units
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      m |= (unsigned)(pods[i] > 0) << i;
      big |= (unsigned)(pods[i] > 8) << i;
    }
    for (; m; m &= m - 1u) {
      const int i = __ffs(m) - 1, k = k0 + i * T;
      ++cnt;
      first = min(first, k);
      atomicOr(s_new + (k >> 5), 1u << (k & 31));
      bool bad = (big >> i) & 1u;  // or a class on it that compaction cannot move
      for (int g0 = 0; g0 < Gp; g0 += 8) {
        int v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = g0 + j < Gp ? take[(size_t)(g0 + j) * K + k] : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (v[j] > 0) {
            const int b = s_perm[g0 + j];
            set_class(s_onany, b, Gp);
            bad |= (unsigned)b >= (unsigned)Gp || s_comp[b] == 0;
          }
      }
      nondonor += bad ? 1u : 0u;
    }
  }
  lsum = warp_sum(lsum);
  cnt = warp_sum(cnt);
  nondonor = warp_sum(nondonor);
  for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(kFull, first, o));
  if (lane == 0) {
    s_sum[0][warp] = lsum;
    s_sum[1][warp] = cnt;
    s_sum[2][warp] = nondonor;
    s_first[warp] = first;
  }
  __syncthreads();  // the new-slot mask, the classes on new slots, the sums
  unsigned lo_units = 0u, new_count = 0u, non_donors = 0u;
  first = 0x7fffffff;
  for (int w = 0; w < kSummaryWarps; ++w) {
    lo_units += s_sum[0][w];
    new_count += s_sum[1][w];
    non_donors += s_sum[2][w];
    first = min(first, s_first[w]);
  }
  const int k_star = first == 0x7fffffff ? 0 : first;
  // c_star and its key: a chain of two loads, issued now by the thread that
  // writes the record, to land while the block works on
  const bool writer = tid == kSummaryThreads - 32;
  int cs = 0, key_pool = 0, key_zone = 0, key_ct = 0;
  if (writer) {
    cs = max(node_cfg[k_star], 0);
    key_pool = pool_id[cs];
    key_zone = zone_id[cs];
    key_ct = ct_id[cs];
  }

  // ---- 3. the classes on k_star, its usage, the new slots' load -----------
  for (int g = tid; g < Gp; g += kSummaryThreads)
    if (take[(size_t)g * K + k_star] > 0) set_class(s_onnew, s_perm[g], Gp);
  float* load = vs.load + (size_t)e * 2 * R;
  for (int r = warp; r < R; r += kSummaryWarps) {
    if (lane == 0) load[r] = node_used[(size_t)k_star * R + r];
    float acc = 0.0f;
    for (int w0 = next0 >> 5; w0 < nwords; w0 += 32) {
      const unsigned mine = w0 + lane < nwords ? s_new[w0 + lane] : 0u;
      for (unsigned words = __ballot_sync(kFull, mine != 0u); words;) {
        unsigned bits[4];  // four non-empty words, ascending: loads first
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int wi = words ? __ffs(words) - 1 : 0;
          bits[i] = words ? __shfl_sync(kFull, mine, wi) : 0u;
          words &= words - 1u;
          v[i] = (bits[i] >> lane) & 1u
                     ? node_used[(size_t)((w0 + wi) * 32 + lane) * R + r] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          for (unsigned b = bits[i]; b; b &= b - 1u)
            acc = __fadd_rn(acc, __shfl_sync(kFull, v[i], __ffs(b) - 1));
      }
    }
    if (lane == 0) load[R + r] = acc;
  }
  __syncthreads();  // the flag words are complete
  unsigned* flags = vs.flags + (size_t)e * 2 * W;
  for (int w = tid; w < 2 * W; w += kSummaryThreads) flags[w] = s_onnew[w];  // then s_onany
  if (writer) {
    int* rec = vs.rec + (size_t)e * kRecInts;
    rec[0] = (int)lo_units;
    rec[1] = (int)new_count;
    rec[2] = (int)non_donors;
    rec[3] = cs;
    rec[4] = key_pool;
    rec[5] = key_zone;
    rec[6] = key_ct;
    rec[7] = 0;
    vs.best[e] = ~0ull;  // the argmin cell and hold, neutral
    vs.hold[e] = 0u;
  }
}

// Dynamic shared memory of a config-pass block: the tile's alloc rows plus
// the slack [R][kCfgTile] (thread t reads column t), the group's usage and
// load [2R][kGroup], keys [3][kGroup] and flag words [2W][kGroup] (element
// minor, read four elements at a time).  The instance for many axes
// (kSmemRows false) keeps only the keys and flag words there.
__host__ __device__ inline size_t configs_smem(int G, int R, bool rows = true) {
  const int W = (G + 31) / 32;
  return (size_t)4 * ((rows ? R * kCfgTile + 2 * R * kGroup : 0) + 3 * kGroup +
                      2 * W * kGroup);
}

// Axis j (of 2R: k_star's usage, then the new slots' load) of quad q of the
// group's elements: from shared memory (kSmemRows), else from the records
// in device memory (0 past the group's ng elements, as the staged copy).
template <bool kSmemRows>
__device__ __forceinline__ float4 group_axis(const float* s_el, const VerdictScratch& vs,
                                             int e0, int ng, int R, int j, int q) {
  if (kSmemRows) return reinterpret_cast<const float4*>(s_el + j * kGroup)[q];
  const int el = 4 * q;
  const size_t stride = 2 * (size_t)R;
  const float* col = vs.load + (size_t)(e0 + el) * stride + j;
  return make_float4(el < ng ? col[0] : 0.0f, el + 1 < ng ? col[stride] : 0.0f,
                     el + 2 < ng ? col[2 * stride] : 0.0f, el + 3 < ng ? col[3 * stride] : 0.0f);
}

// Masks of four elements' compares: bit q*4+i from component i.
__device__ __forceinline__ unsigned bits4(bool x, bool y, bool z, bool w, int q) {
  return ((unsigned)x | (unsigned)y << 1 | (unsigned)z << 2 | (unsigned)w << 3) << (4 * q);
}

// The config pass of _verdict_row: config c = tile * kCfgTile + t against
// the elements e0 .. e0 + ng - 1 (ng at most `group`, at most kGroup).  Per
// element: `same` (c's key is c_star's), class_feas (no class on k_star
// outside c's feasibility bits), fits_used (R compares), for the masked
// price's first-index argmin; and for `hold`: holds (R compares), every
// class on a new slot feasible, openable -- only for the elements whose
// row reads it (new_count >= 2, non_donors <= 1: `need`).  A warp skips
// the tests of four elements where no lane needs them, and the two argmin
// reductions of an element no lane's config is open to.  kSmemRows stages
// the tile's alloc rows and the group's usage and load rows in shared
// memory; past the axes a block's shared memory holds (ffd_verdict_max_axes)
// the instance with it false reads both from device memory instead, the
// same arithmetic in the same order.
template <bool kSmemRows>
__global__ void __launch_bounds__(kCfgTile, kCfgMinBlocks) verdict_configs_kernel(
    const uint8_t* __restrict__ feas, const float* __restrict__ alloc,
    const float* __restrict__ price, const uint8_t* __restrict__ openable,
    const int* __restrict__ pool_id, const int* __restrict__ zone_id,
    const int* __restrict__ ct_id, int B, int G, int Cp, int R, int group,
    VerdictScratch vs) {
  extern __shared__ __align__(16) unsigned char csm[];
  __shared__ unsigned long long s_best[kCfgWarps][kGroup];
  __shared__ unsigned s_hold[kCfgWarps];
  __shared__ unsigned s_need;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int W = (G + 31) >> 5;
  const int c0 = blockIdx.x * kCfgTile, e0 = blockIdx.y * group;
  const int ng = min(group, B - e0), nc = min(kCfgTile, Cp - c0);
  const int nq = (ng + 3) >> 2;  // quads of elements
  const int c = c0 + t;
  const bool valid = t < nc;
  const int Rs = kSmemRows ? R : 0;                   // axes staged here
  float* s_alloc = (float*)csm;                       // [Rs][kCfgTile]
  float* s_el = s_alloc + Rs * kCfgTile;              // [2Rs][kGroup]
  int* s_key = (int*)(s_el + 2 * Rs * kGroup);        // [3][kGroup]
  unsigned* s_fl = (unsigned*)(s_key + 3 * kGroup);   // [2W][kGroup]

  // ---- this thread's config, its tile's alloc rows, the group's records --
  float pr = 0.0f;
  int pz = 0, zz = 0, tz = 0;
  bool op = false;
  if (valid) {
    pr = price[c];
    op = openable[c] != 0;
    pz = pool_id[c];
    zz = zone_id[c];
    tz = ct_id[c];
  }
  for (int i = t; i < nc * Rs; i += kCfgTile) {
    const int cl = i / R;
    s_alloc[(i - cl * R) * kCfgTile + cl] = __fadd_rn(alloc[(size_t)c0 * R + i], kFitSlack);
  }
  for (int i = t; i < 2 * Rs * kGroup; i += kCfgTile) {
    const int j = i / kGroup, el = i - j * kGroup;
    s_el[i] = el < ng ? vs.load[(size_t)(e0 + el) * 2 * R + j] : 0.0f;
  }
  for (int i = t; i < 3 * kGroup; i += kCfgTile) {
    const int j = i / kGroup, el = i - j * kGroup;
    s_key[i] = el < ng ? vs.rec[(size_t)(e0 + el) * kRecInts + 4 + j] : 0;
  }
  for (int i = t; i < 2 * W * kGroup; i += kCfgTile) {
    const int j = i / kGroup, el = i - j * kGroup;
    s_fl[i] = el < ng ? vs.flags[(size_t)(e0 + el) * 2 * W + j] : 0u;
  }
  if (warp == 0) {  // the elements whose row reads `hold`
    bool nh = false;
    if (lane < ng) {
      const int* rec = vs.rec + (size_t)(e0 + lane) * kRecInts;
      nh = rec[1] >= 2 && rec[2] <= 1;
    }
    const unsigned m = __ballot_sync(kFull, nh);
    if (lane == 0) s_need = m;
  }
  __syncthreads();

  // ---- the tests, as masks over the group --------------------------------
  unsigned same = 0u;
  for (int q = 0; q < nq; ++q) {
    const int4 p = reinterpret_cast<const int4*>(s_key)[q];
    const int4 z = reinterpret_cast<const int4*>(s_key + kGroup)[q];
    const int4 y = reinterpret_cast<const int4*>(s_key + 2 * kGroup)[q];
    same |= bits4(p.x == pz && z.x == zz && y.x == tz, p.y == pz && z.y == zz && y.y == tz,
                  p.z == pz && z.z == zz && y.z == tz, p.w == pz && z.w == zz && y.w == tz, q);
  }
  const unsigned live = ng == kGroup ? ~0u : (1u << ng) - 1u;
  const unsigned want = valid && op ? same & live : 0u;  // elements c may be the min of
  const unsigned need = valid && op ? s_need : 0u;       // elements c may hold
  const unsigned wf = __reduce_or_sync(kFull, want), wh = __reduce_or_sync(kFull, need);
  unsigned cls = ~0u, any = ~0u;  // class_feas, all_new_feas
  for (int w = 0; w < W && (wf | wh); ++w) {
    const unsigned u = __reduce_or_sync(  // the classes of word w some element flags
        kFull, s_fl[w * kGroup + lane] | s_fl[(W + w) * kGroup + lane]);
    if (u == 0u) continue;
    unsigned fb = 0u;  // c's feasibility bits of the flagged classes of word w
    if (valid) {
      const uint8_t* col = feas + (size_t)w * 32 * Cp + c;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if ((u >> i) & 1u) fb |= (unsigned)(col[(size_t)i * Cp] != 0) << i;
    }
    for (int q = 0; q < nq; ++q) {
      if ((wf >> (4 * q)) & 15u) {
        const uint4 on = reinterpret_cast<const uint4*>(s_fl + w * kGroup)[q];
        cls &= ~bits4((on.x & ~fb) != 0u, (on.y & ~fb) != 0u, (on.z & ~fb) != 0u,
                      (on.w & ~fb) != 0u, q);
      }
      if ((wh >> (4 * q)) & 15u) {
        const uint4 an = reinterpret_cast<const uint4*>(s_fl + (W + w) * kGroup)[q];
        any &= ~bits4((an.x & ~fb) != 0u, (an.y & ~fb) != 0u, (an.z & ~fb) != 0u,
                      (an.w & ~fb) != 0u, q);
      }
    }
  }
  unsigned fit = ~0u, holds = ~0u;  // fits_used, new_load held
  for (int r = 0; r < R && (wf | wh); ++r) {
    const float a = !valid ? 0.0f
                    : kSmemRows ? s_alloc[r * kCfgTile + t]
                                : __fadd_rn(alloc[(size_t)c * R + r], kFitSlack);
    for (int q = 0; q < nq; ++q) {
      if ((wf >> (4 * q)) & 15u) {
        const float4 u = group_axis<kSmemRows>(s_el, vs, e0, ng, R, r, q);
        fit &= ~bits4(!(u.x <= a), !(u.y <= a), !(u.z <= a), !(u.w <= a), q);
      }
      if ((wh >> (4 * q)) & 15u) {
        const float4 l = group_axis<kSmemRows>(s_el, vs, e0, ng, R, R + r, q);
        holds &= ~bits4(!(l.x <= a), !(l.y <= a), !(l.z <= a), !(l.w <= a), q);
      }
    }
  }
  const unsigned ok = want & cls & fit;
  const unsigned hk = need & holds & any;

  // ---- argmin and hold: the warp, the block, then across blocks ----------
  const unsigned pk = price_key(pr), cu = valid ? (unsigned)c : ~0u;
  const unsigned wok = __reduce_or_sync(kFull, ok);
  const unsigned first_c = __reduce_min_sync(kFull, cu);  // ~0u: no config in the warp
  const unsigned long long none =  // every lane's masked price +inf
      (unsigned long long)(first_c == ~0u ? ~0u : kInfKey) << 32 | first_c;
  unsigned long long mine = ~0ull;
  for (int el = 0; el < ng; ++el) {
    unsigned long long v = none;
    if ((wok >> el) & 1u) {
      const unsigned hi = valid ? ((ok >> el) & 1u ? pk : kInfKey) : ~0u;
      const unsigned mn = __reduce_min_sync(kFull, hi);
      const unsigned ci = __reduce_min_sync(kFull, hi == mn ? cu : ~0u);
      v = (unsigned long long)mn << 32 | ci;
    }
    if (lane == el) mine = v;
  }
  s_best[warp][lane] = mine;
  const unsigned hw = __reduce_or_sync(kFull, hk);
  if (lane == 0) s_hold[warp] = hw;
  __syncthreads();
  if (t < ng) {
    unsigned long long b = s_best[0][t];
    unsigned h = s_hold[0];
    for (int w = 1; w < kCfgWarps; ++w) {
      b = min(b, s_best[w][t]);
      h |= s_hold[w];
    }
    atomicMin(vs.best + e0 + t, b);
    if ((h >> t) & 1u) atomicOr(vs.hold + e0 + t, 1u);
  }
}

// Row e of the verdicts from its record, its argmin cell and hold.
__global__ void __launch_bounds__(kWriteThreads) verdict_write_kernel(
    const float* __restrict__ price, int B, VerdictScratch vs, float* __restrict__ rows) {
  const int e = blockIdx.x * kWriteThreads + threadIdx.x;
  if (e >= B) return;
  const int* rec = vs.rec + (size_t)e * kRecInts;
  const unsigned long long best = vs.best[e];
  const int bidx = (int)(unsigned)best;
  float* row = rows + (size_t)e * kVerdictWidth;
  row[0] = (float)rec[0];
  row[1] = (float)rec[1];
  row[2] = (float)bidx;
  // the masked price at bidx: +inf where every config is masked
  row[3] = (unsigned)(best >> 32) == kInfKey ? INFINITY : price[bidx];
  row[4] = (float)rec[3];
  row[5] = (rec[1] >= 2 && rec[2] <= 1 && vs.hold[e]) ? 1.0f : 0.0f;
}

constexpr int kPrologueThreads = 256;
constexpr int kPopKeyAbsent = 1 << 30;  // ops/packer.py: POP_KEY_ABSENT
constexpr int kPopOccAbsent = 1 << 29;  // ops/packer.py: POP_OCC_ABSENT

// Dynamic shared memory of a prologue block: the mask's bit words
// [ceil(U / 32)], count and key [Gp] each, then the partial (count, first
// occurrence) of each thread [kPrologueThreads] each.
__host__ __device__ inline size_t prologue_smem(int U, int Gp) {
  return (size_t)4 * ((U + 31) / 32 + 2 * Gp + 2 * kPrologueThreads);
}

// population_verdict_kernel's per-member prologue for member p: cnt[g] =
// the int32 sum of cand_cnt[j][g] over the selected candidates j, occ[g]
// their first occurrence (min of cand_occ), key[g] = sort_rank[g] *
// occ_span + occ[g] where cnt[g] > 0, else POP_KEY_ABSENT; rm = the
// selected candidates' live slots (those past K dropped); then a stable
// sort of the keys by rank -- (key, index) pairs are distinct, so rank(g)
// is the count of pairs before g's -- gives perm[rank(g)] = g and the
// counts in that order.
// The mask is staged once as bit words (a ballot over sel).  The classes
// go in blocks of up to kPrologueThreads; within one, gw classes by nj =
// kPrologueThreads / gw candidate lanes: thread t takes class t % gw and
// candidates t / gw, t / gw + nj, ..., so consecutive threads read
// consecutive (j * Gp + g) and each selected pair costs one load of each
// tensor.  The lanes of a class fold in a tree in shared memory: the count
// as a wrapping unsigned sum and the occurrence as a min, both
// order-free, so exact.  rm is zeroed with 16-byte stores where K % 16 ==
// 0 (the row is then 16-byte aligned), else with byte stores, and the
// selected slots set after a barrier.
__global__ void __launch_bounds__(kPrologueThreads) population_pairs_kernel(
    const int* __restrict__ cand_cnt, const int* __restrict__ cand_slot,
    const int* __restrict__ cand_occ, const int* __restrict__ sort_rank,
    const uint8_t* __restrict__ masks, int U, int Gp, int K, int occ_span,
    int* __restrict__ cnt_b, uint8_t* __restrict__ rm_b, int* __restrict__ perm_b) {
  extern __shared__ __align__(16) unsigned psm[];
  const int UW = (U + 31) >> 5;
  unsigned* s_sel = psm;                              // [UW]
  int* s_cnt = (int*)(s_sel + UW);                    // [Gp]
  int* s_key = s_cnt + Gp;                            // [Gp]
  unsigned* s_pc = (unsigned*)(s_key + Gp);           // [kPrologueThreads]
  int* s_po = (int*)(s_pc + kPrologueThreads);        // [kPrologueThreads]
  const int p = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint8_t* sel = masks + (size_t)p * U;
  uint8_t* rm = rm_b + (size_t)p * K;

  for (int j0 = warp * 32; j0 < U; j0 += kPrologueThreads) {
    const unsigned m = __ballot_sync(kFull, j0 + lane < U && sel[j0 + lane] != 0);
    if (lane == 0) s_sel[j0 >> 5] = m;
  }
  if ((K & 15) == 0) {
    for (int i = t; i < K / 16; i += kPrologueThreads)
      reinterpret_cast<uint4*>(rm)[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int k = t; k < K; k += kPrologueThreads) rm[k] = 0;
  }
  __syncthreads();  // the mask is staged, the zeros land before a slot is set
  for (int j = t; j < U; j += kPrologueThreads)
    if ((s_sel[j >> 5] >> (j & 31)) & 1u) {
      const int k = cand_slot[j];
      if (k >= 0 && k < K) rm[k] = 1;
    }
  for (int gb = 0; gb < Gp; gb += kPrologueThreads) {
    const int gw = min(Gp - gb, kPrologueThreads);
    const int nj = kPrologueThreads / gw;  // candidate lanes a class
    const int jl = t / gw, g = gb + t - jl * gw;
    const int rank_g = t < gw ? sort_rank[gb + t] : 0;
    if (jl < nj) {
      unsigned c = 0u;
      int occ = kPopOccAbsent;
#pragma unroll 4
      for (int j = jl; j < U; j += nj)
        if ((s_sel[j >> 5] >> (j & 31)) & 1u) {
          c += (unsigned)cand_cnt[(size_t)j * Gp + g];
          occ = min(occ, cand_occ[(size_t)j * Gp + g]);
        }
      s_pc[t] = c;  // lane jl of class g: slot jl * gw + (g - gb) = t
      s_po[t] = occ;
    }
    __syncthreads();
    for (int n = nj; n > 1;) {  // lanes [h, n) fold onto [0, n - h)
      const int h = (n + 1) >> 1;
      if (t < (n - h) * gw) {
        s_pc[t] += s_pc[t + h * gw];
        s_po[t] = min(s_po[t], s_po[t + h * gw]);
      }
      n = h;
      __syncthreads();
    }
    if (t < gw) {
      const int cc = (int)s_pc[t];
      s_cnt[gb + t] = cc;
      s_key[gb + t] = cc > 0 ? wadd(wmul(rank_g, occ_span), s_po[t]) : kPopKeyAbsent;
    }
    __syncthreads();  // the partials are free for the next block of classes
  }
  for (int g = t; g < Gp; g += kPrologueThreads) {
    const int kg = s_key[g];
    int rank = 0;
    for (int h = 0; h < Gp; ++h) {
      const int kh = s_key[h];
      rank += (kh < kg || (kh == kg && h < g)) ? 1 : 0;
    }
    perm_b[(size_t)p * Gp + rank] = g;
    cnt_b[(size_t)p * Gp + rank] = s_cnt[g];
  }
}

// ---------------------------------------------------------------------------
// The admission score (the single-pod fast path)
// ---------------------------------------------------------------------------
//
// Takes the place of the JAX package's admit_kernel
// (karpenter_tpu/ops/packer.py:197-241), a jitted XLA function, not a
// Pallas kernel; its plain version is karpenter_tpu_torch/ops/packer.py:
// admit_reference.  The fast path (scheduling/fastpath.py) scores ONE class
// g against the live nodes of a resident state: _pack_core's existing-node
// fill for that class alone.  Per slot k, cap = node_cap(alloc[cfg0[k]],
// used0[k], req[g]) where cfg0[k] >= 0 and feas[g][cfg0[k]], else 0; an
// exclusive int32 prefix over the slots (it wraps, as XLA's cumsum does:
// a class that requests no axis has 2^30 room a slot); take = clip(cnt[g]
// - prefix, 0, cap).  Then the placed total (a wrapping sum) and whether
// some config c may open a node of the class: feas[g][c], openable[c] and
// node_cap(alloc[c], req[g]) > 0.  out = [take[0..K), placed, open_ok]:
// K + 2 int32 words, so the host fetches one buffer.  The arithmetic is
// node_cap's (__fsub_rn, __fdiv_rn, __fadd_rn, floorf, fminf in axis
// order) and the sums are unsigned, so the result is bit-equal to the
// reference (the fast path's host oracle demands it).
//
// What bounds it: one SM.  At the live cluster (Kp 4096, Cp 8192, R 6) it
// moves a few hundred KB, well under a microsecond at the card's memory
// rate, but one block runs on one SM: its L1 serves about one 128-byte
// line a cycle to all warps, its four schedulers issue about one warp
// instruction a cycle each, and a thread's rounds run one after another
// behind its dependent loads.  A strided walk over the configs that waits
// on each stride's test is one dependent round a stride; a contiguous run
// of slots or configs a thread makes each warp-wide row load touch 32
// lines; and a zero dividend (a slot with no config) takes __fdiv_rn's
// slow path.  So:
//   1. Coalesced.  Slot round i of warp w is the block round of 32 x W
//      slots (W warps) at (i W + w) 32, lane l its slot (i W + w) 32 + l;
//      config round r likewise (r W + w) 32 + l.  A warp's byte loads read
//      one line, its alloc and used0 rows six (24 bytes apart at R 6; the
//      live slots' configs are consecutive columns), its take stores one,
//      and the live slots (the first ones) spread over every warp.
//   2. One load round before anything waits: the class row (up to
//      kAdmitRow axes), its count, the slots' configs (up to kAdmitSlots
//      rounds) and the feasibility and openable bytes of its first
//      kAdmitRounds config rounds (the next ones' with the group that
//      reaches them).  The block's threads are the caller's
//      (fused_packer.admit_threads: a multiple of 32 up to kAdmitThreads,
//      at most kAdmitSlots slot rounds a thread up to K 4096).
//   3. Then a second, issued together: per slot round of the first group
//      (2 rounds), fg[c] and the requested axes of alloc[c] and used0[k];
//      per candidate config (feasible and openable) of the first group (2
//      rounds), the requested axes of alloc; later groups follow.  The
//      class's requested axes (the set bits of the row, at most
//      kAdmitAxes) are the template argument of admit_held, so no
//      instruction runs for an axis the class does not request.  A slot
//      with no config or an infeasible one divides nothing, and an axis
//      with r >= q, or r <= fl(0.99 q), needs no division either
//      (admit_axis_holds_none: its floor is >= 1, or 0).  A warp stops
//      testing configs once one of its lanes has found one that fits: the
//      open bit is an any().
//   4. Two barriers.  Each warp's slot total of each round and its
//      __any_sync of the open test go to their own shared words; after the
//      one barrier each warp sums, round by round, the totals of the
//      rounds before and of the warps before it (__reduce_add_sync).  Then
//      the takes, a warp sum of them, the second barrier, and warp 0 sums
//      the warp sums and reads the open words.
// A class row wider than kAdmitRow axes, or one that requests more than
// kAdmitAxes of them, takes node_cap's loop for every slot and config, and
// more than kAdmitSlots slot rounds (K > 4096) give each warp a contiguous
// run of slots whose caps are staged in the output's own words between
// the scan's two passes: any K, Cp and R.
constexpr int kAdmitThreads = 512;  // the block's bound (one block an SM: 128 registers a thread)
constexpr int kAdmitSlots = 8;      // slot rounds whose caps a thread keeps
constexpr int kAdmitRounds = 4;     // config rounds whose bytes a thread loads at once
constexpr int kAdmitAxes = 4;       // requested axes admit_held takes
constexpr int kAdmitRow = 8;        // axes of the class row loaded at once

// What a thread of the admission block holds: its inputs, its lane and
// warp, its slot rounds (ns) and their configs (-1 past K), its candidate
// configs' bits (round r: bit r) and the class's requested axes (bits of
// `axes`).
struct AdmitThread {
  const float* rq;
  const uint8_t* fg;
  const uint8_t* openable;
  const float* alloc;
  const float* used0;
  int R, Cp, ns, lane, nw, warp;
  unsigned cand, axes;
  int cf[kAdmitSlots];
  // slot round i of a held slot: a block round of 32 x nw slots, warp
  // after warp
  __device__ __forceinline__ int slot(int i) const { return (i * nw + warp) * 32 + lane; }
  // config round r: a block round of 32 x nw configs, warp after warp
  __device__ __forceinline__ int config(int r) const { return (r * nw + warp) * 32 + lane; }
};

// The feasible-and-openable bits of config rounds [r0, r0 + kAdmitRounds):
// a byte of each row a config, a warp's 32 on one line.
__device__ __forceinline__ unsigned admit_candidates(const AdmitThread& th, int r0) {
  uint8_t f[kAdmitRounds], o[kAdmitRounds];
#pragma unroll
  for (int r = 0; r < kAdmitRounds; ++r) {
    const int c = th.config(r0 + r);
    f[r] = c < th.Cp ? th.fg[c] : 0;
    o[r] = c < th.Cp ? th.openable[c] : 0;
  }
  unsigned m = 0u;
#pragma unroll
  for (int r = 0; r < kAdmitRounds; ++r) m |= (f[r] && o[r] ? 1u : 0u) << r;
  return m;
}

// node_cap's floor(fl(fl(r / q) + 1e-4)) of one axis (q > 0), decided
// without its division where that is exact.  r >= q: the floor is >= 1
// (fl(r / q) >= 1, rounding being monotone), or NaN at inf / inf, which
// fminf ignores.  r < q and r <= fl(0.99 q) (admit_axis_holds_none): r / q
// <= 0.99 (1 + 2^-24), so the floor is 0 or below (for a q of a few
// subnormal ulps fl(0.99 q) may round to q, but then r, a whole number of
// ulps below q, is at most (1 - 1/50) q).
__device__ __forceinline__ bool admit_axis_holds_none(float r, float q) {
  return r < q && r <= __fmul_rn(0.99f, q);
}

// Whether one axis of a config holds a pod: node_cap's floor >= 1, or NaN.
__device__ __forceinline__ bool admit_axis_holds(float a, float q) {
  return a >= q ||
         (!admit_axis_holds_none(a, q) && !(floorf(__fadd_rn(__fdiv_rn(a, q), kNudge)) < 1.0f));
}

// Whether a candidate among the CG config rounds from r0 (bits of m, bit 0
// round r0) holds a pod of the class: node_cap(alloc[c], req) > 0, every
// requested axis's floor >= 1 or NaN (fminf ignores NaN).
template <int NA, int CG>
__device__ __forceinline__ bool admit_fits(const AdmitThread& th, unsigned m, int r0,
                                           const int* ax, const float* q) {
  constexpr int A = NA > 0 ? NA : 1;
  float a[CG][A];
#pragma unroll
  for (int i = 0; i < CG; ++i)
#pragma unroll
    for (int j = 0; j < NA; ++j)
      a[i][j] = (m >> i) & 1u ? th.alloc[(size_t)th.config(r0 + i) * th.R + ax[j]] : 0.0f;
  bool fits = false;
#pragma unroll
  for (int i = 0; i < CG; ++i) {
    bool ok = (m >> i) & 1u;
#pragma unroll
    for (int j = 0; j < NA; ++j)
      ok = ok && admit_axis_holds(a[i][j], q[j]);
    fits |= ok;
  }
  return fits;
}

// The caps of slot rounds [i0, i0 + SG) (0 past ns or for a slot with no
// config or an infeasible one), the NA requested axes of their rows loaded
// together.
template <int NA, int SG>
__device__ __forceinline__ void admit_caps(const AdmitThread& th, int i0, const int* ax,
                                           const float* q, int* cap) {
  constexpr int A = NA > 0 ? NA : 1;
  float a[SG][A], u[SG][A];
  bool f[SG];
#pragma unroll
  for (int s = 0; s < SG; ++s) {
    const int c = th.cf[i0 + s];
    f[s] = c >= 0 && th.fg[c];
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      a[s][j] = c >= 0 ? th.alloc[(size_t)c * th.R + ax[j]] : 0.0f;
      u[s][j] = c >= 0 ? th.used0[(size_t)th.slot(i0 + s) * th.R + ax[j]] : 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < SG; ++s) {
    float rem[A];
    bool none = false;  // an axis that holds no pod: the cap is 0
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      rem[j] = __fsub_rn(a[s][j], u[s][j]);
      none |= admit_axis_holds_none(rem[j], q[j]);
    }
    cap[i0 + s] = 0;
    if (f[s] && !none) {
      float m = kBigF;
#pragma unroll
      for (int j = 0; j < NA; ++j)
        m = fminf(m, floorf(__fadd_rn(__fdiv_rn(rem[j], q[j]), kNudge)));
      cap[i0 + s] = (int)fmaxf(m, 0.0f);
    }
  }
}

// A class of NA requested axes: its held slots' caps and whether one of
// the thread's configs opens a node of the class.
template <int NA>
__device__ __forceinline__ void admit_held(const AdmitThread& th, int rounds, int* cap,
                                           bool& fits) {
  constexpr int A = NA > 0 ? NA : 1;
  constexpr int SG = 2;                 // slot rounds a group
  constexpr int CG = 2;                 // config rounds a group
  int ax[A];
  float q[A];
  unsigned bits = th.axes;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    ax[j] = __ffs(bits) - 1;
    bits &= bits - 1;
    q[j] = th.rq[ax[j]];
  }
  admit_caps<NA, SG>(th, 0, ax, q, cap);
  fits = admit_fits<NA, CG>(th, th.cand & ((1u << CG) - 1u), 0, ax, q);
#pragma unroll
  for (int i0 = SG; i0 < kAdmitSlots; i0 += SG)
    if (i0 < th.ns) admit_caps<NA, SG>(th, i0, ax, q, cap);
  unsigned m = th.cand;
  for (int r0 = CG; r0 < rounds && !__any_sync(kFull, fits); r0 += CG) {
    if (r0 % kAdmitRounds == 0) m = admit_candidates(th, r0);
    const int sh = r0 % kAdmitRounds;
    fits = admit_fits<NA, CG>(th, (m >> sh) & ((1u << CG) - 1u), r0, ax, q);
  }
}

// A wide row: node_cap's loop for every slot and candidate config.
__device__ __forceinline__ void admit_wide(const AdmitThread& th, int rounds, int* cap,
                                           bool& fits) {
  fits = false;
  unsigned m = th.cand;
  for (int r = 0; r < rounds; ++r) {  // warp-uniform, for the __any_sync
    if (r % kAdmitRounds == 0 && r > 0) {
      if (__any_sync(kFull, fits)) break;
      m = admit_candidates(th, r);
    }
    if (!fits && ((m >> (r % kAdmitRounds)) & 1u))
      fits = node_cap(th.alloc + (size_t)th.config(r) * th.R, nullptr, th.rq, th.R) > 0;
  }
#pragma unroll
  for (int i = 0; i < kAdmitSlots; ++i) {
    const int c = th.cf[i];
    cap[i] = c >= 0 && th.fg[c] ? node_cap(th.alloc + (size_t)c * th.R,
                                           th.used0 + (size_t)th.slot(i) * th.R, th.rq, th.R)
                                : 0;
  }
}

// Warp inclusive scan (wrapping).
__device__ __forceinline__ unsigned warp_incl_scan(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__global__ void __launch_bounds__(kAdmitThreads, 1) admit_kernel(
    const float* __restrict__ req, const int* __restrict__ cnt,
    const uint8_t* __restrict__ feas, const float* __restrict__ alloc,
    const uint8_t* __restrict__ openable, const float* __restrict__ used0,
    const int* __restrict__ cfg0, int Cp, int K, int R, int g, int* __restrict__ out) {
  // slot round totals of each warp (a staged launch: the warp's total)
  __shared__ unsigned sh_total[kAdmitSlots][32], sh_open[32], sh_placed[32];
  AdmitThread th;
  th.rq = req + (size_t)g * R;
  th.fg = feas + (size_t)g * Cp;
  th.openable = openable;
  th.alloc = alloc;
  th.used0 = used0;
  th.R = R;
  th.Cp = Cp;
  th.lane = threadIdx.x & 31;
  th.warp = threadIdx.x >> 5;
  th.nw = blockDim.x >> 5;
  th.ns = (K + (int)blockDim.x - 1) / (int)blockDim.x;
  const int rounds = (Cp + (int)blockDim.x - 1) / (int)blockDim.x;
  const bool held = th.ns <= kAdmitSlots;

  // round 1: the class row and count, the slots' configs, the configs' bytes
  float row[kAdmitRow];
#pragma unroll
  for (int r = 0; r < kAdmitRow; ++r) row[r] = r < R ? th.rq[r] : 0.0f;
  const int n_g = cnt[g];
#pragma unroll
  for (int i = 0; i < kAdmitSlots; ++i)
    th.cf[i] = held && i < th.ns && th.slot(i) < K ? cfg0[th.slot(i)] : -1;
  th.cand = admit_candidates(th, 0);
  th.axes = 0u;
#pragma unroll
  for (int r = 0; r < kAdmitRow; ++r) th.axes |= (row[r] > 0.0f ? 1u : 0u) << r;
  const int na = __popc(th.axes);

  // the caps and the open test
  int cap[kAdmitSlots];
  bool fits = false;
  const int base = th.warp * 32 * th.ns;  // a staged warp's contiguous slots
  if (!held) {  // K > 4096: node_cap's loop, the caps staged in the output words
    admit_wide(th, rounds, cap, fits);
    unsigned off = 0u;
    for (int i = 0; i < th.ns; ++i) {
      const int k = base + 32 * i + th.lane;
      const int c = k < K ? cfg0[k] : -1;
      const int ck = c >= 0 && th.fg[c] ? node_cap(alloc + (size_t)c * R, used0 + (size_t)k * R,
                                                   th.rq, R)
                                        : 0;
      if (k < K) out[k] = ck;
      off += __shfl_sync(kFull, warp_incl_scan((unsigned)ck, th.lane), 31);
    }
    cap[0] = (int)off;  // the warp's total
  } else if (R <= kAdmitRow && na <= kAdmitAxes) {
    switch (na) {
      case 0: admit_held<0>(th, rounds, cap, fits); break;
      case 1: admit_held<1>(th, rounds, cap, fits); break;
      case 2: admit_held<2>(th, rounds, cap, fits); break;
      case 3: admit_held<3>(th, rounds, cap, fits); break;
      default: admit_held<4>(th, rounds, cap, fits); break;
    }
  } else {
    admit_wide(th, rounds, cap, fits);
  }

  // each held slot's prefix within its warp's part of its round; barrier
  // 1: the round totals of the warps (a staged warp's total) and the open
  // bit
  unsigned pre[kAdmitSlots];
  if (held) {
#pragma unroll
    for (int i = 0; i < kAdmitSlots; ++i) {
      if (i < th.ns) {
        const unsigned incl = warp_incl_scan((unsigned)cap[i], th.lane);
        pre[i] = incl - (unsigned)cap[i];
        if (th.lane == 31) sh_total[i][th.warp] = incl;
      }
    }
  } else if (th.lane == 0) {
    sh_total[0][th.warp] = (unsigned)cap[0];
  }
  const bool warp_fits = __any_sync(kFull, fits);
  if (th.lane == 0) sh_open[th.warp] = warp_fits;
  __syncthreads();

  // the takes; barrier 2: the placed total
  unsigned placed = 0u;
  if (held) {
    unsigned before = 0u;  // the slots of the earlier rounds
#pragma unroll
    for (int i = 0; i < kAdmitSlots; ++i) {
      if (i < th.ns) {
        const unsigned t = th.lane < th.nw ? sh_total[i][th.lane] : 0u;
        const unsigned off = before + __reduce_add_sync(kFull, th.lane < th.warp ? t : 0u);
        before += __reduce_add_sync(kFull, t);
        const int k = th.slot(i);
        if (k < K) {
          const int take = clip(wsub(n_g, (int)(off + pre[i])), 0, cap[i]);
          out[k] = take;
          placed += (unsigned)take;
        }
      }
    }
  } else {
    unsigned o = __reduce_add_sync(kFull, th.lane < th.warp ? sh_total[0][th.lane] : 0u);
    for (int i = 0; i < th.ns; ++i) {
      const int k = base + 32 * i + th.lane;
      const int ck = k < K ? out[k] : 0;
      const unsigned incl = warp_incl_scan((unsigned)ck, th.lane);
      const int take = clip(wsub(n_g, (int)(o + incl - (unsigned)ck)), 0, ck);
      if (k < K) out[k] = take;
      placed += (unsigned)take;
      o += __shfl_sync(kFull, incl, 31);
    }
  }
  placed = __reduce_add_sync(kFull, placed);
  if (th.lane == 0) sh_placed[th.warp] = placed;
  __syncthreads();
  if (th.warp == 0) {
    const unsigned total = __reduce_add_sync(kFull, th.lane < th.nw ? sh_placed[th.lane] : 0u);
    const bool open_ok = __any_sync(kFull, th.lane < th.nw && sh_open[th.lane]);
    if (th.lane == 0) {
      out[K] = (int)total;
      out[K + 1] = open_ok ? 1 : 0;
    }
  }
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The scan mode of a C batch descriptor, or -1 where it is not a valid one.
int mode_of(int nb, const int* perm_b, const int* cnt_b, const uint8_t* rm_b,
            const int* done_b, const int* next0_b) {
  if (nb < 1 || nb > 65535) return -1;
  if (next0_b) return (perm_b || cnt_b || rm_b || done_b) ? -1 : kFleet;
  if (perm_b) return (cnt_b && rm_b) ? kWhatIf : -1;
  return (nb == 1 && !done_b) ? kSolo : -1;
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 = launched).  `nb`
// problems of one shape (1 for a solve; the fleet pack's B up to 65,535),
// each input and output stacked element after element.
int ffd_choose_config(const float* req, const int* maxper, const uint8_t* feas,
                      const float* alloc, const float* price,
                      const uint8_t* openable, int Gp, int Cp, int R,
                      int objective, int nb, int* c_star, int* new_ok, int* per,
                      void* stream) {
  if (Gp <= 0) return 0;
  if (Cp <= 0 || nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  // with Cp % 4 == 0 every element's slice keeps its base's alignment
  const int vec = Cp % 4 == 0 && reinterpret_cast<uintptr_t>(feas) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(openable) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(price) % 16 == 0;
  const auto st = (cudaStream_t)stream;
  const dim3 grid(Gp, nb);
  const ChooseTile none{0, 0, Cp, nullptr};
  if (Cp > kBlockConfigs)
    choose_config_kernel<true, false><<<grid, kChooseThreads, 0, st>>>(
        req, maxper, feas, alloc, price, openable, Cp, R, objective, vec,
        c_star, new_ok, per, none);
  else
    choose_config_kernel<false, false><<<grid, kChooseThreads, 0, st>>>(
        req, maxper, feas, alloc, price, openable, Cp, R, objective, vec,
        c_star, new_ok, per, none);
  return (int)cudaGetLastError();
}

// One tile of the sharded pack's choice: classes [g0, g1) over the configs
// [c0, c1) (non-empty) of a catalog of C, the price ceiling over all C;
// rec [g1 - g0][4] int32 records (choose_config_kernel<., true>).
int ffd_choose_config_shard(const float* req, const int* maxper,
                            const uint8_t* feas, const float* alloc,
                            const float* price, const uint8_t* openable,
                            int C, int R, int g0, int g1, int c0, int c1,
                            int objective, int* rec, void* stream) {
  if (g1 <= g0) return 0;
  const int Cp = c1 - c0;
  if (Cp <= 0 || c0 < 0 || c1 > C || g0 < 0) return (int)cudaErrorInvalidValue;
  // every feasibility row starts at g * C + c0: aligned where C, c0 and
  // the base are
  const int vec = Cp % 4 == 0 && C % 4 == 0 && c0 % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(feas) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(openable) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(price) % 16 == 0;
  const auto st = (cudaStream_t)stream;
  const ChooseTile tile{g0, c0, C, rec};
  if (Cp > kBlockConfigs)
    choose_config_kernel<true, true><<<g1 - g0, kChooseThreads, 0, st>>>(
        req, maxper, feas, alloc, price, openable, Cp, R, objective, vec,
        nullptr, nullptr, nullptr, tile);
  else
    choose_config_kernel<false, true><<<g1 - g0, kChooseThreads, 0, st>>>(
        req, maxper, feas, alloc, price, openable, Cp, R, objective, vec,
        nullptr, nullptr, nullptr, tile);
  return (int)cudaGetLastError();
}

// The batch descriptor of every scan: `nb` elements (1 to 65,535) and
// perm_b / cnt_b [nb][Gp], rm_b [nb][K], all null for the solve's scan
// (nb 1), and done_b [nb] (ffd_scan_window's mask: the elements it
// finished are skipped) or null; each output (and the global scan's
// sigcnt) holds nb elements' worth, element after element.  next0_b [nb]
// set (and perm_b, cnt_b, rm_b, done_b null) is a fleet launch: every
// input, c_star / new_ok / per included, holds nb problems of one shape,
// element after element, and `next0` is not read (mode_of).
int ffd_scan_global(const float* req, const int* cnt, const int* maxper,
                    const int* slot, const uint8_t* feas, const float* alloc,
                    const int* c_star, const int* new_ok, const int* per,
                    const float* used0, const int* cfg0, const int* npods0,
                    const int* sig0, int Gp, int Cp, int K, int R, int S,
                    int next0, int nb, const int* perm_b, const int* cnt_b,
                    const uint8_t* rm_b, const int* done_b, const int* next0_b,
                    int* take, int* leftover, int* cfg, int* npods, float* used,
                    int* sigcnt, void* stream) {
  if (K <= 0) return 0;
  const int mode = mode_of(nb, perm_b, cnt_b, rm_b, done_b, next0_b);
  if (mode < 0) return (int)cudaErrorInvalidValue;
  const Batch bt{perm_b, cnt_b, rm_b, done_b, next0_b};
  const dim3 grid(1, nb);
  const auto st = (cudaStream_t)stream;
#define FFD_LAUNCH(MODE)                                                        \
  ffd_scan_global_kernel<MODE><<<grid, scan_threads(K), R * sizeof(float), st>>>( \
      req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per, used0, cfg0,     \
      npods0, sig0, Gp, Cp, K, R, S, next0, bt, take, leftover, cfg, npods, used,\
      sigcnt)
  switch (mode) {
    case kWhatIf: FFD_LAUNCH(kWhatIf); break;
    case kFleet: FFD_LAUNCH(kFleet); break;
    default: FFD_LAUNCH(kSolo);
  }
#undef FFD_LAUNCH
  return (int)cudaGetLastError();
}

// The resident scan: `slots_per_thread` is 1 or 2 with
// slots_per_thread * scan_threads(K) >= K (larger slot counts do not fit
// a block's shared memory and go to ffd_scan_cluster or ffd_scan_global),
// `smem_bytes` the
// dynamic shared memory the wrapper computed for it, `chunk` (4, 8 or 16)
// divides Cp and the address of feas.
int ffd_scan(const float* req, const int* cnt, const int* maxper,
             const int* slot, const uint8_t* feas, const float* alloc,
             const int* c_star, const int* new_ok, const int* per,
             const float* used0, const int* cfg0, const int* npods0,
             const int* sig0, int Gp, int Cp, int K, int R, int S, int next0,
             int slots_per_thread, int smem_bytes, int chunk, int nb,
             const int* perm_b, const int* cnt_b, const uint8_t* rm_b,
             const int* done_b, const int* next0_b, int* take, int* leftover,
             int* cfg, int* npods, float* used, void* stream) {
  if (K <= 0) return 0;
  const int threads = scan_threads(K);
  const int mode = mode_of(nb, perm_b, cnt_b, rm_b, done_b, next0_b);
  if ((chunk != 4 && chunk != 8 && chunk != 16) || Cp % chunk != 0 ||
      R > kMaxR || (long long)slots_per_thread * threads < K || mode < 0)
    return (int)cudaErrorInvalidValue;
  const Batch bt{perm_b, cnt_b, rm_b, done_b, next0_b};
#define FFD_LAUNCH(M, MODE)                                                  \
  launch_resident<M, MODE>(req, cnt, maxper, slot, feas, alloc, c_star,      \
                           new_ok, per, used0, cfg0, npods0, sig0, Gp, Cp,   \
                           K, R, S, next0, threads, smem_bytes, chunk, nb,   \
                           bt, take, leftover, cfg, npods, used,             \
                           (cudaStream_t)stream)
#define FFD_MODES(M)                                                         \
  (mode == kWhatIf  ? FFD_LAUNCH(M, kWhatIf)                                 \
   : mode == kFleet ? FFD_LAUNCH(M, kFleet)                                  \
                    : FFD_LAUNCH(M, kSolo))
  switch (slots_per_thread) {
    case 1: return FFD_MODES(1);
    case 2: return FFD_MODES(2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFD_MODES
#undef FFD_LAUNCH
}

// The cluster-resident scan on one cluster of `ctas` (2, 4 or 8) CTAs of
// scan_threads(ceil(K / ctas)) threads, `slots_per_thread` (1 or 2) slots
// a thread; `smem_bytes` per CTA as the wrapper computed it
// (fused_packer.cluster_layout), `chunk` as for ffd_scan, `wrap_guard`
// with K * (wrap_guard - 1) < 2^31.  Returns -2 where no such cluster fits
// the card at once.
int ffd_scan_cluster(const float* req, const int* cnt, const int* maxper,
                     const int* slot, const uint8_t* feas, const float* alloc,
                     const int* c_star, const int* new_ok, const int* per,
                     const float* used0, const int* cfg0, const int* npods0,
                     const int* sig0, int Gp, int Cp, int K, int R, int S,
                     int next0, int ctas, int slots_per_thread, int smem_bytes,
                     int chunk, int wrap_guard, int nb, const int* perm_b,
                     const int* cnt_b, const uint8_t* rm_b, const int* done_b,
                     const int* next0_b, int* take, int* leftover, int* cfg,
                     int* npods, float* used, void* stream) {
  if (K <= 0) return 0;
  if (ctas != 2 && ctas != 4 && ctas != 8) return (int)cudaErrorInvalidValue;
  const int mode = mode_of(nb, perm_b, cnt_b, rm_b, done_b, next0_b);
  if (mode < 0) return (int)cudaErrorInvalidValue;
  const Batch bt{perm_b, cnt_b, rm_b, done_b, next0_b};
  const int threads = scan_threads((K + ctas - 1) / ctas);
  if ((chunk != 4 && chunk != 8 && chunk != 16) || Cp % chunk != 0 ||
      R > kMaxR || wrap_guard < 1 ||
      (long long)wrap_guard - 1 > (long long)0x7fffffff / K ||
      (long long)ctas * slots_per_thread * threads < K)
    return (int)cudaErrorInvalidValue;
#define FFD_LAUNCH(M, MODE)                                                  \
  launch_cluster<M, MODE>(req, cnt, maxper, slot, feas, alloc, c_star, new_ok, \
                          per, used0, cfg0, npods0, sig0, Gp, Cp, K, R, S,    \
                          next0, ctas, threads, smem_bytes, chunk, wrap_guard,\
                          nb, bt, take, leftover, cfg, npods, used,           \
                          (cudaStream_t)stream)
#define FFD_MODES(M)                                                         \
  (mode == kWhatIf  ? FFD_LAUNCH(M, kWhatIf)                                 \
   : mode == kFleet ? FFD_LAUNCH(M, kFleet)                                  \
                    : FFD_LAUNCH(M, kSolo))
  switch (slots_per_thread) {
    case 1: return FFD_MODES(1);
    case 2: return FFD_MODES(2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFD_MODES
#undef FFD_LAUNCH
}

// The frontier-window scan of nb elements (1 to 65,535; perm_b, cnt_b,
// rm_b as above, all set) on a window of `window` slots (256, 512 or
// 1024) with `smem_bytes` of shared memory (fused_packer.window_layout),
// `chunk` as for ffd_scan; done_b [nb] gets 1 for each element it
// finished and 0 for each it left to the next launch on the stream.
int ffd_scan_window(const float* req, const int* maxper, const int* slot,
                    const uint8_t* feas, const float* alloc, const int* c_star,
                    const int* new_ok, const int* per, const float* used0,
                    const int* cfg0, const int* npods0, const int* sig0, int Gp,
                    int Cp, int K, int R, int S, int next0, int window,
                    int smem_bytes, int chunk, int nb, const int* perm_b,
                    const int* cnt_b, const uint8_t* rm_b, int* take, int* leftover,
                    int* cfg, int* npods, float* used, int* done_b, void* stream) {
  if (K <= 0) return 0;
  if ((chunk != 4 && chunk != 8 && chunk != 16) || Cp % chunk != 0 || R > kMaxR ||
      nb < 1 || nb > 65535 || !(perm_b && cnt_b && rm_b && done_b) || next0 < 0 ||
      next0 > K)
    return (int)cudaErrorInvalidValue;
  const Batch bt{perm_b, cnt_b, rm_b, nullptr};
#define FFD_LAUNCH(M)                                                              \
  launch_window<M>(req, maxper, slot, feas, alloc, c_star, new_ok, per, used0, cfg0, \
                   npods0, sig0, Gp, Cp, K, R, S, next0, smem_bytes, chunk, nb, bt, \
                   take, leftover, cfg, npods, used, done_b, (cudaStream_t)stream)
  switch (window) {
    case 1 * kWinThreads: return FFD_LAUNCH(1);
    case 2 * kWinThreads: return FFD_LAUNCH(2);
    case 4 * kWinThreads: return FFD_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFD_LAUNCH
}

// How many elements of a batched scan (the what-if instances) run on the
// card at once: kind 0 the
// resident scan (blocks of `threads` with `smem_bytes`, M slots a thread),
// 1 the cluster scan (clusters of `ctas`), 2 the global scan, 3 the
// frontier-window scan (M rounds of kWinThreads slots); negative on a
// CUDA error.
int ffd_scan_concurrency(int kind, int M, int ctas, int threads, int smem_bytes) {
  int dev = 0, sms = 0, n = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  if (kind == 3) {
    const auto kernel = M == 1   ? ffd_scan_window_kernel<1>
                        : M == 2 ? ffd_scan_window_kernel<2>
                                 : ffd_scan_window_kernel<4>;
    e = allow_smem(kernel, smem_bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kWinThreads, smem_bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return -(int)e;
    }
    return n * sms;
  }
  if (kind == 0 || kind == 2) {
    if (kind == 0)
      e = M == 1 ? allow_smem(ffd_scan_kernel<1, kWhatIf>, smem_bytes)
                 : allow_smem(ffd_scan_kernel<2, kWhatIf>, smem_bytes);
    if (e == cudaSuccess)
      e = kind == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, ffd_scan_global_kernel<kWhatIf>, threads, smem_bytes)
          : M == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, ffd_scan_kernel<1, kWhatIf>, threads, smem_bytes)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, ffd_scan_kernel<2, kWhatIf>, threads, smem_bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return -(int)e;
    }
    return n * sms;
  }
  const auto kernel =
      M == 1 ? ffd_scan_cluster_kernel<1, kWhatIf> : ffd_scan_cluster_kernel<2, kWhatIf>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas, 1, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem_bytes;
  config.attrs = attr;
  config.numAttrs = 1;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &config);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return n;
}

// The bytes of verdict_rows' scratch for B elements, G classes and R axes.
long long ffd_verdict_scratch_bytes(int B, int G, int R) {
  size_t bytes = 0;
  verdict_scratch(nullptr, B, G, R, &bytes);
  return (long long)bytes;
}

// The config pass's configs a block (kCfgTile) and its largest element
// group (kGroup), for the wrapper's choice of group.
int ffd_verdict_config_tile() { return kCfgTile; }
int ffd_verdict_max_group() { return kGroup; }

// The most resource axes the config pass stages in shared memory at G
// classes on the current device: its tile's alloc rows, R x kCfgTile
// floats, and the group's rows (about 179 axes in a Hopper block's 227 KB).
// Past it verdict_rows takes the instance that reads them from device
// memory.  A negative CUDA error code where the device query fails.
int ffd_verdict_max_axes(int G) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, verdict_configs_kernel<true>);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  const long long room = (long long)optin - (long long)attr.sharedSizeBytes -
                         (long long)configs_smem(G, 0);
  const long long per_axis = (long long)(configs_smem(G, 1) - configs_smem(G, 0));
  return room < 0 ? 0 : (int)(room / per_axis);
}

// The verdict rows of a batched scan's B elements, `rows` [B][6]: the
// summary, the config pass (`group` elements a block, 1 to 32) and the
// write, in order on `stream`, over `scratch`
// (ffd_verdict_scratch_bytes(B, Gp, R) bytes, 16-byte aligned).  The config
// pass stages its rows in shared memory where `smem_rows` is set (R at most
// ffd_verdict_max_axes(Gp)), else reads them from device memory (any R).
int ffd_verdict_rows(const int* take, const int* leftover, const int* node_cfg,
                     const int* node_pods, const float* node_used,
                     const int* perm_b, const uint8_t* feas, const float* alloc,
                     const float* price, const uint8_t* openable,
                     const int* pool_id, const int* zone_id, const int* ct_id,
                     const uint8_t* compactable, int B, int Gp, int Cp, int K,
                     int R, int next0, int group, int smem_rows, void* scratch,
                     float* rows, void* stream) {
  if (B <= 0) return 0;
  if (Gp < 0 || Cp <= 0 || K <= 0 || R < 0 || next0 < 0 || next0 > K || group < 1 ||
      group > kGroup || (B + group - 1) / group > 65535 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem_s = summary_smem(Gp, K), smem_c = configs_smem(Gp, R, smem_rows != 0);
  cudaError_t e = allow_smem(verdict_summary_kernel, smem_s);
  if (e == cudaSuccess)
    e = smem_rows ? allow_smem(verdict_configs_kernel<true>, smem_c)
                  : allow_smem(verdict_configs_kernel<false>, smem_c);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const VerdictScratch vs = verdict_scratch(scratch, B, Gp, R, nullptr);
  const auto st = (cudaStream_t)stream;
  verdict_summary_kernel<<<B, kSummaryThreads, smem_s, st>>>(
      take, leftover, node_cfg, node_pods, node_used, perm_b, pool_id, zone_id,
      ct_id, compactable, Gp, K, R, next0, vs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Cp + kCfgTile - 1) / kCfgTile, (B + group - 1) / group);
  if (smem_rows)
    verdict_configs_kernel<true><<<grid, kCfgTile, smem_c, st>>>(
        feas, alloc, price, openable, pool_id, zone_id, ct_id, B, Gp, Cp, R, group, vs);
  else
    verdict_configs_kernel<false><<<grid, kCfgTile, smem_c, st>>>(
        feas, alloc, price, openable, pool_id, zone_id, ct_id, B, Gp, Cp, R, group, vs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  verdict_write_kernel<<<(B + kWriteThreads - 1) / kWriteThreads, kWriteThreads, 0, st>>>(
      price, B, vs, rows);
  return (int)cudaGetLastError();
}

// The population prologue of P removal masks over U candidates: cnt_b
// [P][Gp], rm_b [P][K], perm_b [P][Gp].
int ffd_population_prologue(const int* cand_cnt, const int* cand_slot,
                            const int* cand_occ, const int* sort_rank,
                            const uint8_t* masks, int P, int U, int Gp, int K,
                            int occ_span, int* cnt_b, uint8_t* rm_b,
                            int* perm_b, void* stream) {
  if (P <= 0) return 0;
  if (U < 0 || Gp < 0 || K <= 0 || occ_span < 0 ||
      ((K & 15) == 0 && reinterpret_cast<uintptr_t>(rm_b) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = prologue_smem(U, Gp);
  const cudaError_t e = allow_smem(population_pairs_kernel, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  population_pairs_kernel<<<P, kPrologueThreads, smem, (cudaStream_t)stream>>>(
      cand_cnt, cand_slot, cand_occ, sort_rank, masks, U, Gp, K, occ_span, cnt_b,
      rm_b, perm_b);
  return (int)cudaGetLastError();
}

// The admission score of class g (admit_kernel above): req [Gp][R], cnt
// [Gp], feas [Gp][Cp], alloc [Cp][R], openable [Cp], used0 [K][R], cfg0
// [K] (values in [-1, Cp)), out [K + 2]; `threads` a multiple of 32 from 32
// to kAdmitThreads (any such count is exact; fused_packer.admit_threads
// picks it).
int ffd_admit(const float* req, const int* cnt, const uint8_t* feas,
              const float* alloc, const uint8_t* openable, const float* used0,
              const int* cfg0, int Gp, int Cp, int K, int R, int g, int threads, int* out,
              void* stream) {
  if (g < 0 || g >= Gp || Cp < 0 || K < 0 || R < 0 || threads < 32 ||
      threads > kAdmitThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  admit_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      req, cnt, feas, alloc, openable, used0, cfg0, Cp, K, R, g, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
