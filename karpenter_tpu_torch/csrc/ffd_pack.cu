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
//   choose_config_kernel<kMulti>  grid (Gp,): one block per class picks
//                           the config a new node of that class opens on
//                           (first-index argmin of the objective's score
//                           over C); see "The choice" below.
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
// (N, B)) per element, for the consolidation verdicts, whose last steps are
// verdict_rows_kernel and population_prologue_kernel (see "The
// consolidation verdicts" below).  The solve's scan is the one element B =
// 1 with no descriptor.
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

// The batch axis of a what-if scan launch (the consolidation verdicts,
// ops/fused_packer.py: ffd_scan_batch).  Element e scans the base class
// rows perm[e][0..Gp) in that order, with the counts cnt[e][g] (in the
// element's order) and the slots k with rm[e][k] set removed: their config
// is -1 from the start, so they take nothing, and the survivors keep their
// first-fit order.  The choice (c_star, new_ok, per) is the base's, read
// through the base row: a class's choice depends on its own row and the
// price ceiling alone.  All null: the solve's scan, one element, the base
// rows in order.  perm is read where a class row or a feasibility row is
// loaded, never per slot.
struct Batch {
  const int* perm;    // [B][Gp] base rows, or null
  const int* cnt;     // [B][Gp] counts, or null (the base's cnt)
  const uint8_t* rm;  // [B][K] removed slots, or null
};

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

// Element e of a batched launch (every pointer of bt set), or, with
// kBatched false, the solve's one element, whose null perm and rm the
// compiler folds away: the solve's instance of each scan is the scan
// without a batch axis.
template <bool kBatched>
__device__ __forceinline__ Elem elem_of(const Batch& bt, const int* cnt, int e,
                                        int Gp, int K) {
  Elem el{nullptr, cnt, nullptr};
  if (kBatched) {
    el.perm = bt.perm + (size_t)e * Gp;
    el.cnt = bt.cnt + (size_t)e * Gp;
    el.rm = bt.rm + (size_t)e * K;
  }
  return el;
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

// ---- the choice (see "The choice" above) ----------------------------------

constexpr int kChooseThreads = 256;
constexpr int kChooseWarps = kChooseThreads / 32;
constexpr int kChooseMinBlocks = 3;           // blocks a SM: caps registers
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

// kMulti: Cp > kBlockConfigs, so the thread walks several blocks.
template <bool kMulti>
__global__ void __launch_bounds__(kChooseThreads, kChooseMinBlocks)
    choose_config_kernel(
    const float* __restrict__ req, const int* __restrict__ maxper,
    const uint8_t* __restrict__ feas, const float* __restrict__ alloc,
    const float* __restrict__ price, const uint8_t* __restrict__ openable,
    int Cp, int R, int objective, int vec, int* __restrict__ c_star,
    int* __restrict__ new_ok, int* __restrict__ per) {
  __shared__ float s_pm[kChooseWarps];
  __shared__ float s_val[kChooseWarps];
  __shared__ int s_idx[kChooseWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x;
  const ChooseRow t{feas + (size_t)g * Cp, req + (size_t)g * R, Cp, vec != 0};
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
  float pm = fold_ceiling(cur, 0, Cp, -INFINITY);
  if constexpr (kMulti) {
    load_block(nxt, 1, t, price, openable);  // before this block's divisions
    pm = fold_ceiling(nxt, 1, Cp, pm);
    for (int b = 2; b < nb; ++b) {  // later blocks: a ceiling-only read
      ChooseBlock far;
      load_block(far, b, t, price, openable);
      pm = fold_ceiling(far, b, Cp, pm);
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
      c_star[g] = c;
      new_ok[g] = (t.feas[c] && openable[c] && cap_c > 0) ? 1 : 0;
      per[g] = max(cap_c, 1);
    }
  }
}

template <bool kBatched>
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
  const int e = kBatched ? blockIdx.y : 0;  // batch element
  const Elem el = elem_of<kBatched>(bt, cnt, e, Gp, K);
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

// ---------------------------------------------------------------------------
// The resident scan
// ---------------------------------------------------------------------------

// The Python wrapper (ops/fused_packer.py: SCAN_RING, SCAN_TILE,
// SCAN_XCHG_BYTES, MAX_AXES, resident_layout) sizes the shared memory from
// these; the kernel traps if the bytes it is given do not cover its layout.
constexpr int kRing = 8;   // feasibility rows in flight
constexpr int kTile = 32;  // classes per tile of class rows
constexpr int kMaxR = 31;  // resource axes, at most: one flag bit each
constexpr unsigned kFinite = 1u << 31;
constexpr int kXchgBytes = 2 * 32 * 4 + 32 * 4 + 2 * 32 * 4;

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

template <int M, bool kBatched>  // consecutive slots each thread owns; batch axis
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
  const int e = kBatched ? blockIdx.y : 0;  // batch element
  const Elem el = elem_of<kBatched>(bt, cnt, e, Gp, K);
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
  for (int i = tid; i < K * R; i += B) {
    const unsigned u = __float_as_uint(used0[i]);
    odd |= u == 0x80000000u || (isnan(__uint_as_float(u)) && u != 0x7fffffffu);
  }
  const bool used_clean = !__syncthreads_or(odd);

  // ---- classes 0 .. kRing-2 in flight and the first tile, before step 0 ---
  for (int h = 0; h < kRing - 1; ++h) {
    if (h < Gp) issue_feas(el.row(h), ring + (size_t)h * slot_bytes, chunk, feas, Cp);
    cp_async_commit();
  }
  load_tile(0, tiles, Gp, Cp, R, el, req, alloc, maxper, slot, c_star, new_ok, per);
  // the base row of the class whose feasibility row the next step issues,
  // loaded a step ahead of its use
  int ring_row = kBatched && Gp > kRing - 1 ? el.row(kRing - 1) : 0;
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
      const int h = g + kRing - 1, hr = kBatched ? ring_row : h;
      if (kBatched && h + 1 < Gp) ring_row = el.row(h + 1);
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
          *u = __fadd_rn(*u, __fmul_rn(tf, creq[r]));
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

template <int M, bool kBatched>
int launch_resident(const float* req, const int* cnt, const int* maxper,
                    const int* slot, const uint8_t* feas, const float* alloc,
                    const int* c_star, const int* new_ok, const int* per,
                    const float* used0, const int* cfg0, const int* npods0,
                    const int* sig0, int Gp, int Cp, int K, int R, int S,
                    int next0, int threads, int smem_bytes, int chunk,
                    int nb, Batch bt, int* take, int* leftover, int* cfg,
                    int* npods, float* used, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      ffd_scan_kernel<M, kBatched>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)e;
  }
  ffd_scan_kernel<M, kBatched><<<dim3(1, nb), threads, smem_bytes, stream>>>(
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

template <int M, bool kBatched>  // consecutive slots each thread owns; batch axis
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
  const int e = kBatched ? blockIdx.y : 0;  // batch element: the cluster's grid row
  const Elem el = elem_of<kBatched>(bt, cnt, e, Gp, K);
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
  for (int i = tid; i < own * R; i += B) {
    const unsigned u = __float_as_uint(used0[(size_t)k0 * R + i]);
    odd |= u == 0x80000000u || (isnan(__uint_as_float(u)) && u != 0x7fffffffu);
  }
  const bool used_clean = !__syncthreads_or(odd);

  for (int h = 0; h < kRing - 1; ++h) {
    if (h < Gp) issue_feas(el.row(h), ring + (size_t)h * slot_bytes, chunk, feas, Cp);
    cp_async_commit();
  }
  load_tile(0, tiles, Gp, Cp, R, el, req, alloc, maxper, slot, c_star, new_ok, per);
  // the base row of the class whose feasibility row the next step issues,
  // loaded a step ahead of its use
  int ring_row = kBatched && Gp > kRing - 1 ? el.row(kRing - 1) : 0;
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
      const int h = g + kRing - 1, hr = kBatched ? ring_row : h;
      if (kBatched && h + 1 < Gp) ring_row = el.row(h + 1);
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
          *u = __fadd_rn(*u, __fmul_rn(tf, creq[r]));
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

template <int M, bool kBatched>
int launch_cluster(const float* req, const int* cnt, const int* maxper,
                   const int* slot, const uint8_t* feas, const float* alloc,
                   const int* c_star, const int* new_ok, const int* per,
                   const float* used0, const int* cfg0, const int* npods0,
                   const int* sig0, int Gp, int Cp, int K, int R, int S,
                   int next0, int ctas, int threads, int smem_bytes, int chunk,
                   int wrap_guard, int nb, Batch bt, int* take, int* leftover,
                   int* cfg, int* npods, float* used, cudaStream_t stream) {
  const auto kernel = ffd_scan_cluster_kernel<M, kBatched>;
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
// The consolidation verdicts
// ---------------------------------------------------------------------------
//
// The JAX package answers B what-if removals with two jitted XLA functions,
// removal_verdict_kernel and population_verdict_kernel
// (karpenter_tpu/ops/packer.py), each _pack_core vmapped over B problems
// plus a per-element epilogue, _verdict_row.  Here the B scans are one
// launch of the scans above with the batch axis (Batch), and two kernels
// do the rest:
//   verdict_rows_kernel         grid (B,): one block per element reads its
//                               scan outputs and writes the six-value
//                               verdict row;
//   population_prologue_kernel  grid (P,): one block per removal mask
//                               derives its counts, removed slots and FFD
//                               class order, the batched scan's inputs.
// Both are small next to the scans: what bounds them is the latency of a
// few dependent passes of one block, so each keeps its passes few and its
// reads coalesced (threads over slots, classes or configs, consecutive
// threads on consecutive addresses).

constexpr int kVerdictThreads = 256;
constexpr int kVerdictWarps = kVerdictThreads / 32;
constexpr float kFitSlack = 1e-6f;  // `used <= alloc + 1e-6`
constexpr int kVerdictWidth = 6;    // ops/packer.py: RV_WIDTH

// (s, i) goes before (bs, bi) in a first-index argmin.
__device__ __forceinline__ bool argmin_before(float s, int i, float bs, int bi) {
  return s < bs || (s == bs && i < bi);
}

// Dynamic shared memory of one verdict block: new_load [R] and the first
// new slot's usage [R] floats, the element's base rows [Gp], the new-slot
// bit mask [ceil(K / 32)], then two flag bytes a class.
__host__ __device__ inline size_t verdict_smem(int Gp, int K, int R) {
  return (size_t)4 * (2 * R + Gp + (K + 31) / 32) + (size_t)2 * Gp;
}

// _verdict_row's epilogue over element e's scan outputs (the batched
// layout of ffd_scan_batch).  Pass 1: the leftover sum.  Pass 2, threads
// over the slots [next0, K): the new slots (node_pods > 0; newmask is false
// below next0), their count, the first (k_star, else 0: argmax of an
// all-false mask), the non-donors, and per class whether it sits on some
// new slot.  Pass 3: per class whether it sits on k_star; per axis
// k_star's usage and new_load, summed in ascending slot order over the bit
// mask of new slots.  Pass 4, threads over the configs: the masked price's
// first-index argmin and `hold`.  All counts int32, the row float32 as
// JAX's.
__global__ void __launch_bounds__(kVerdictThreads) verdict_rows_kernel(
    const int* __restrict__ take, const int* __restrict__ leftover,
    const int* __restrict__ node_cfg, const int* __restrict__ node_pods,
    const float* __restrict__ node_used, const int* __restrict__ perm_b,
    const uint8_t* __restrict__ feas, const float* __restrict__ alloc,
    const float* __restrict__ price, const uint8_t* __restrict__ openable,
    const int* __restrict__ pool_id, const int* __restrict__ zone_id,
    const int* __restrict__ ct_id, const uint8_t* __restrict__ compactable,
    int Gp, int Cp, int K, int R, int next0, float* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char vsm[];
  __shared__ unsigned s_sum[3][kVerdictWarps];  // leftover, new slots, non-donors
  __shared__ int s_first[kVerdictWarps];
  __shared__ float s_best[kVerdictWarps];
  __shared__ int s_bidx[kVerdictWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.x;
  const int nwords = (K + 31) >> 5;
  take += (size_t)e * Gp * K;
  leftover += (size_t)e * Gp;
  node_cfg += (size_t)e * K;
  node_pods += (size_t)e * K;
  node_used += (size_t)e * K * R;
  perm_b += (size_t)e * Gp;
  float* s_load = (float*)vsm;                     // [R]
  float* s_usedk = s_load + R;                     // [R]
  int* s_perm = (int*)(s_usedk + R);               // [Gp]
  unsigned* s_new = (unsigned*)(s_perm + Gp);      // [nwords]
  uint8_t* s_onnew = (uint8_t*)(s_new + nwords);   // [Gp]
  uint8_t* s_onany = s_onnew + Gp;                 // [Gp]

  // ---- 1. the leftover sum (wrapping, as int32); flags cleared ------------
  unsigned lsum = 0u;
  for (int g = tid; g < Gp; g += kVerdictThreads) {
    lsum += (unsigned)leftover[g];
    s_perm[g] = perm_b[g];
    s_onany[g] = 0;
  }
  for (int w = tid; w < nwords; w += kVerdictThreads) s_new[w] = 0u;
  __syncthreads();

  // ---- 2. the new slots ----------------------------------------------------
  unsigned cnt = 0u, nondonor = 0u;
  int first = 0x7fffffff;
  for (int k = next0 + tid; k < K; k += kVerdictThreads) {
    const int pods = node_pods[k];
    if (pods > 0) {
      ++cnt;
      first = min(first, k);
      atomicOr(s_new + (k >> 5), 1u << (k & 31));
      bool bad = false;  // a class on it that compaction cannot move
      for (int g = 0; g < Gp; ++g)
        if (take[(size_t)g * K + k] > 0) {
          s_onany[g] = 1;
          bad |= compactable[s_perm[g]] == 0;
        }
      nondonor += (pods > 8 || bad) ? 1u : 0u;
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
  __syncthreads();
  unsigned lo_units = 0u, new_count = 0u, non_donors = 0u;
  first = 0x7fffffff;
  for (int w = 0; w < kVerdictWarps; ++w) {
    lo_units += s_sum[0][w];
    new_count += s_sum[1][w];
    non_donors += s_sum[2][w];
    first = min(first, s_first[w]);
  }
  const int k_star = first == 0x7fffffff ? 0 : first;
  const int cs = max(node_cfg[k_star], 0);

  // ---- 3. the classes on k_star, its usage, the new slots' load -----------
  for (int g = tid; g < Gp; g += kVerdictThreads)
    s_onnew[g] = take[(size_t)g * K + k_star] > 0;
  for (int r = tid; r < R; r += kVerdictThreads) {
    s_usedk[r] = node_used[(size_t)k_star * R + r];
    float acc = 0.0f;
    for (int w = next0 >> 5; w < nwords; ++w)
      for (unsigned bits = s_new[w]; bits; bits &= bits - 1u) {
        const int k = w * 32 + __ffs(bits) - 1;
        acc = __fadd_rn(acc, node_used[(size_t)k * R + r]);
      }
    s_load[r] = acc;
  }
  __syncthreads();

  // ---- 4. the configs --------------------------------------------------------
  const int pc = pool_id[cs], zc = zone_id[cs], tc = ct_id[cs];
  float best = INFINITY;
  int bidx = 0x7fffffff;
  bool hold = false;
  for (int c = tid; c < Cp; c += kVerdictThreads) {
    const bool op = openable[c] != 0;
    bool class_feas = true, all_new_feas = true;
    for (int g = 0; g < Gp; ++g) {
      const bool on = s_onnew[g] != 0, any = s_onany[g] != 0;
      if (on || any) {
        const bool f = feas[(size_t)s_perm[g] * Cp + c] != 0;
        class_feas &= !on || f;
        all_new_feas &= !any || f;
      }
    }
    bool fits_used = true, holds = true;
    for (int r = 0; r < R; ++r) {
      const float a = __fadd_rn(alloc[(size_t)c * R + r], kFitSlack);
      fits_used &= s_usedk[r] <= a;
      holds &= s_load[r] <= a;
    }
    const bool same = pool_id[c] == pc && zone_id[c] == zc && ct_id[c] == tc;
    const float masked = (op && class_feas && fits_used && same) ? price[c] : INFINITY;
    if (argmin_before(masked, c, best, bidx)) {
      best = masked;
      bidx = c;
    }
    hold |= holds && op && all_new_feas;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_xor_sync(kFull, best, o);
    const int oi = __shfl_xor_sync(kFull, bidx, o);
    if (argmin_before(os, oi, best, bidx)) {
      best = os;
      bidx = oi;
    }
  }
  if (lane == 0) {
    s_best[warp] = best;
    s_bidx[warp] = bidx;
  }
  const bool any_hold = __syncthreads_or(hold) != 0;
  if (tid == 0) {
    for (int w = 0; w < kVerdictWarps; ++w)
      if (argmin_before(s_best[w], s_bidx[w], best, bidx)) {
        best = s_best[w];
        bidx = s_bidx[w];
      }
    float* row = rows + (size_t)e * kVerdictWidth;
    row[0] = (float)(int)lo_units;
    row[1] = (float)(int)new_count;
    row[2] = (float)bidx;
    row[3] = best;  // the masked price at bidx: +inf where every one is
    row[4] = (float)cs;
    row[5] = ((int)new_count >= 2 && (int)non_donors <= 1 && any_hold) ? 1.0f : 0.0f;
  }
}

constexpr int kPrologueThreads = 256;
constexpr int kPopKeyAbsent = 1 << 30;  // ops/packer.py: POP_KEY_ABSENT
constexpr int kPopOccAbsent = 1 << 29;  // ops/packer.py: POP_OCC_ABSENT

// population_verdict_kernel's per-member prologue for member p: cnt[g] =
// the int32 sum of cand_cnt[j][g] over the selected candidates j, occ[g]
// their first occurrence (min of cand_occ), key[g] = sort_rank[g] *
// occ_span + occ[g] where cnt[g] > 0, else POP_KEY_ABSENT; rm = the
// selected candidates' live slots (those past K dropped); then a stable
// sort of the keys by rank -- (key, index) pairs are distinct, so rank(g)
// is the count of pairs before g's -- gives perm[rank(g)] = g and the
// counts in that order.
__global__ void __launch_bounds__(kPrologueThreads) population_prologue_kernel(
    const int* __restrict__ cand_cnt, const int* __restrict__ cand_slot,
    const int* __restrict__ cand_occ, const int* __restrict__ sort_rank,
    const uint8_t* __restrict__ masks, int U, int Gp, int K, int occ_span,
    int* __restrict__ cnt_b, uint8_t* __restrict__ rm_b, int* __restrict__ perm_b) {
  extern __shared__ int psm[];  // key [Gp], cnt [Gp]
  int* s_key = psm;
  int* s_cnt = psm + Gp;
  const int p = blockIdx.x, tid = threadIdx.x;
  const uint8_t* sel = masks + (size_t)p * U;
  uint8_t* rm = rm_b + (size_t)p * K;
  for (int g = tid; g < Gp; g += kPrologueThreads) {
    unsigned c = 0u;
    int occ = kPopOccAbsent;
    for (int j = 0; j < U; ++j)
      if (sel[j]) {
        c += (unsigned)cand_cnt[(size_t)j * Gp + g];
        occ = min(occ, cand_occ[(size_t)j * Gp + g]);
      }
    s_cnt[g] = (int)c;
    s_key[g] = (int)c > 0 ? wadd(wmul(sort_rank[g], occ_span), occ) : kPopKeyAbsent;
  }
  for (int k = tid; k < K; k += kPrologueThreads) rm[k] = 0;
  __syncthreads();  // the zeros land before any slot is set
  for (int j = tid; j < U; j += kPrologueThreads) {
    const int k = cand_slot[j];
    if (sel[j] && k >= 0 && k < K) rm[k] = 1;
  }
  for (int g = tid; g < Gp; g += kPrologueThreads) {
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

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
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
  if (Cp <= 0) return (int)cudaErrorInvalidValue;
  const int vec = Cp % 4 == 0 && reinterpret_cast<uintptr_t>(feas) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(openable) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(price) % 16 == 0;
  const auto st = (cudaStream_t)stream;
  if (Cp > kBlockConfigs)
    choose_config_kernel<true><<<Gp, kChooseThreads, 0, st>>>(
        req, maxper, feas, alloc, price, openable, Cp, R, objective, vec,
        c_star, new_ok, per);
  else
    choose_config_kernel<false><<<Gp, kChooseThreads, 0, st>>>(
        req, maxper, feas, alloc, price, openable, Cp, R, objective, vec,
        c_star, new_ok, per);
  return (int)cudaGetLastError();
}

// The batch descriptor of every scan: `nb` elements (1 to 65,535) and
// perm_b / cnt_b [nb][Gp], rm_b [nb][K], all null for the solve's scan
// (nb 1); each output (and the global scan's sigcnt) holds nb elements'
// worth, element after element.
int ffd_scan_global(const float* req, const int* cnt, const int* maxper,
                    const int* slot, const uint8_t* feas, const float* alloc,
                    const int* c_star, const int* new_ok, const int* per,
                    const float* used0, const int* cfg0, const int* npods0,
                    const int* sig0, int Gp, int Cp, int K, int R, int S,
                    int next0, int nb, const int* perm_b, const int* cnt_b,
                    const uint8_t* rm_b, int* take, int* leftover, int* cfg,
                    int* npods, float* used, int* sigcnt, void* stream) {
  if (K <= 0) return 0;
  if (nb < 1 || nb > 65535 || (perm_b && !(cnt_b && rm_b)) || (!perm_b && nb != 1))
    return (int)cudaErrorInvalidValue;
  const Batch bt{perm_b, cnt_b, rm_b};
  const dim3 grid(1, nb);
  const auto st = (cudaStream_t)stream;
  if (perm_b)
    ffd_scan_global_kernel<true><<<grid, scan_threads(K), R * sizeof(float), st>>>(
        req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per, used0, cfg0,
        npods0, sig0, Gp, Cp, K, R, S, next0, bt, take, leftover, cfg, npods, used,
        sigcnt);
  else
    ffd_scan_global_kernel<false><<<grid, scan_threads(K), R * sizeof(float), st>>>(
        req, cnt, maxper, slot, feas, alloc, c_star, new_ok, per, used0, cfg0,
        npods0, sig0, Gp, Cp, K, R, S, next0, bt, take, leftover, cfg, npods, used,
        sigcnt);
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
             int* take, int* leftover, int* cfg, int* npods, float* used,
             void* stream) {
  if (K <= 0) return 0;
  const int threads = scan_threads(K);
  if ((chunk != 4 && chunk != 8 && chunk != 16) || Cp % chunk != 0 ||
      R > kMaxR || (long long)slots_per_thread * threads < K || nb < 1 ||
      nb > 65535 || (perm_b && !(cnt_b && rm_b)) || (!perm_b && nb != 1))
    return (int)cudaErrorInvalidValue;
  const Batch bt{perm_b, cnt_b, rm_b};
#define FFD_LAUNCH(M, BATCHED)                                               \
  launch_resident<M, BATCHED>(req, cnt, maxper, slot, feas, alloc, c_star,   \
                              new_ok, per, used0, cfg0, npods0, sig0, Gp, Cp,\
                              K, R, S, next0, threads, smem_bytes, chunk, nb,\
                              bt, take, leftover, cfg, npods, used,          \
                              (cudaStream_t)stream)
  switch (slots_per_thread) {
    case 1: return perm_b ? FFD_LAUNCH(1, true) : FFD_LAUNCH(1, false);
    case 2: return perm_b ? FFD_LAUNCH(2, true) : FFD_LAUNCH(2, false);
    default: return (int)cudaErrorInvalidValue;
  }
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
                     const int* cnt_b, const uint8_t* rm_b, int* take,
                     int* leftover, int* cfg, int* npods, float* used,
                     void* stream) {
  if (K <= 0) return 0;
  if (ctas != 2 && ctas != 4 && ctas != 8) return (int)cudaErrorInvalidValue;
  if (nb < 1 || nb > 65535 || (perm_b && !(cnt_b && rm_b)) || (!perm_b && nb != 1))
    return (int)cudaErrorInvalidValue;
  const Batch bt{perm_b, cnt_b, rm_b};
  const int threads = scan_threads((K + ctas - 1) / ctas);
  if ((chunk != 4 && chunk != 8 && chunk != 16) || Cp % chunk != 0 ||
      R > kMaxR || wrap_guard < 1 ||
      (long long)wrap_guard - 1 > (long long)0x7fffffff / K ||
      (long long)ctas * slots_per_thread * threads < K)
    return (int)cudaErrorInvalidValue;
#define FFD_LAUNCH(M, BATCHED)                                                 \
  launch_cluster<M, BATCHED>(req, cnt, maxper, slot, feas, alloc, c_star, new_ok, \
                             per, used0, cfg0, npods0, sig0, Gp, Cp, K, R, S,    \
                             next0, ctas, threads, smem_bytes, chunk, wrap_guard,\
                             nb, bt, take, leftover, cfg, npods, used,           \
                             (cudaStream_t)stream)
  switch (slots_per_thread) {
    case 1: return perm_b ? FFD_LAUNCH(1, true) : FFD_LAUNCH(1, false);
    case 2: return perm_b ? FFD_LAUNCH(2, true) : FFD_LAUNCH(2, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFD_LAUNCH
}

// How many elements of a batched scan (the kBatched instances) run on the
// card at once: kind 0 the
// resident scan (blocks of `threads` with `smem_bytes`, M slots a thread),
// 1 the cluster scan (clusters of `ctas`), 2 the global scan; negative on
// a CUDA error.
int ffd_scan_concurrency(int kind, int M, int ctas, int threads, int smem_bytes) {
  int dev = 0, sms = 0, n = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  if (kind == 0 || kind == 2) {
    if (kind == 0)
      e = M == 1 ? allow_smem(ffd_scan_kernel<1, true>, smem_bytes)
                 : allow_smem(ffd_scan_kernel<2, true>, smem_bytes);
    if (e == cudaSuccess)
      e = kind == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, ffd_scan_global_kernel<true>, threads, smem_bytes)
          : M == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, ffd_scan_kernel<1, true>, threads, smem_bytes)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, ffd_scan_kernel<2, true>, threads, smem_bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return -(int)e;
    }
    return n * sms;
  }
  const auto kernel =
      M == 1 ? ffd_scan_cluster_kernel<1, true> : ffd_scan_cluster_kernel<2, true>;
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

// The verdict rows of a batched scan's B elements: `rows` [B][6].
int ffd_verdict_rows(const int* take, const int* leftover, const int* node_cfg,
                     const int* node_pods, const float* node_used,
                     const int* perm_b, const uint8_t* feas, const float* alloc,
                     const float* price, const uint8_t* openable,
                     const int* pool_id, const int* zone_id, const int* ct_id,
                     const uint8_t* compactable, int B, int Gp, int Cp, int K,
                     int R, int next0, float* rows, void* stream) {
  if (B <= 0) return 0;
  if (Gp < 0 || Cp <= 0 || K <= 0 || R < 0 || next0 < 0 || next0 > K)
    return (int)cudaErrorInvalidValue;
  const size_t smem = verdict_smem(Gp, K, R);
  const cudaError_t e = allow_smem(verdict_rows_kernel, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  verdict_rows_kernel<<<B, kVerdictThreads, smem, (cudaStream_t)stream>>>(
      take, leftover, node_cfg, node_pods, node_used, perm_b, feas, alloc, price,
      openable, pool_id, zone_id, ct_id, compactable, Gp, Cp, K, R, next0, rows);
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
  if (U < 0 || Gp < 0 || K <= 0 || occ_span < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)8 * Gp;
  const cudaError_t e = allow_smem(population_prologue_kernel, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  population_prologue_kernel<<<P, kPrologueThreads, smem, (cudaStream_t)stream>>>(
      cand_cnt, cand_slot, cand_occ, sort_rank, masks, U, Gp, K, occ_span, cnt_b,
      rm_b, perm_b);
  return (int)cudaGetLastError();
}

}  // extern "C"
