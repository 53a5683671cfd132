#!/usr/bin/env python3
"""Drive karpenter_tpu_torch on one NVIDIA card and check what comes out.

    python3 chip_smoke.py               # every phase
    python3 chip_smoke.py --through N   # phases 1-N (N = 1-6), then exit 3

Phases (each failure exits non-zero before the last line is printed):

1. Device: requires ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles every CUDA source of the package with ``nvcc`` (all at
   once) and prints the ``-Xptxas -v`` summary of each, then the registers
   and spills of each instance of ``choose_config_kernel`` and of the
   verdict and prologue kernels (fails on a spill).
3. Kernel vs plain: each kernel beside its plain PyTorch version on the
   same card tensors, both objectives; every output must be bit-equal, and
   each scan call must launch the kernel expected of it (the wrapper picks
   by shape, `fused_packer.scan_kernel`):
   - each problem at the main path's shapes: the resident tensors a cold
     ``TorchScheduler.solve`` on the card seeds (``ops/resident.py``);
   - config 2 (``heterogeneous_problem``, 512 slots) and the flagship
     (``flagship_problem``): ``choose_config`` and the resident ``ffd_scan``;
     config 2 also through ``ffd_scan_global`` at its own 512 slots;
   - config 2's pods on 2,000 live nodes (4096 slots, Cp 8192), the shape
     at which phase 5's solves launch ``ffd_scan_cluster``: the slot state
     does not fit one block, so the cluster scan, and also the global scan
     and the cluster scan on each other cluster size that holds the shape
     (the sizes phase 4 times in turns);
   - config 2 padded to 4096, 8192 and 16,384 slots: the cluster scan on
     the cluster the shape rule picks for each (8 CTAs of 512 threads, of
     1024, and of 1024 with 2 slots a thread);
   - the wrap case (``testing.wrap_arrays``: the scan's int32 sums wrap) at
     256 slots (resident) and 4096 (cluster, and global), and at 4096 and
     16,384 slots with its prefilled slots straddling slot K / 2, a CTA
     boundary (cluster; at 4096 on every cluster size);
   - the choice alone (``compare_choose``): ``choose_config`` on the three
     main-path problems, the wrap case (Gp 10), ``testing.tie_arrays``
     (first-index ties, a class that fits nothing, a class with maxper 0)
     at 4096 and 16,384 configs, 6 configs, and config 2 with ``feas`` one
     byte off (the last two read a config at a time).
4. Kernel times: each kernel's device time per launch (torch.profiler)
   and its CUDA-event time over many launches after warm-up, beside the
   plain versions' times (CUDA events) and each kernel's bound at this
   run's inputs, at each of the three problems of phase 5 (the scan the
   shapes pick).  At config 2 the global and resident scans run in turns
   (global, resident, resident, global); at the live cluster the global
   and cluster scans (global, cluster, every other cluster size and back,
   cluster, global); their ratios are printed.  The bound counts the bytes
   and operations this run's data needs; each scan kernel also gets its
   latency floor, class steps x (its barriers x barrier round trip + its
   exposed dependent L2 loads x L2 round trip), with the round trips (the
   block barrier per thread count, the cluster barrier per cluster size,
   the L2 load) measured here by ``csrc/latency_probe.cu``.  The kernels
   line gives each kernel at the problem whose solves launch it:
   ``choose_config`` and ``ffd_scan`` at config 2, ``ffd_scan_cluster`` on
   the live cluster, and ``ffd_scan_global`` there too, timed through its
   own entry point.
5. The slice: ``TorchScheduler(device="cuda").solve`` on config 2 (10,000
   pods, 317 classes), on the flagship, and on config 2's pods arriving at
   a cluster of 2,000 live nodes (4096 slots: the cluster scan).  On one
   scheduler a problem, 2 warm-up + 10 timed solves of each kind: cold
   (its compile cache and resident states dropped first), hit (the same
   pods again: a compile-cache hit that packs from the resident tensors)
   and delta (1 % of the pods replaced by new pod objects of existing
   shapes and, on the live cluster, 10 nodes' usage grown: the resident
   tensors absorb the diff).  The launch counters are set to 0 just before
   and read just after.  All pods must be placed; every hit and delta
   solve must pack from the resident tensors; after each delta the card
   tensors must equal their host mirrors bit for bit; every solve must
   launch ``choose_config`` and the scan its shapes pick once (the
   resident one on the two bench problems, the cluster one on the live
   cluster) and none ``ffd_scan_global``; the last cold and the last delta
   result must equal a CPU cold solve through the plain version.  Then one
   solve of each kind per problem runs under torch.profiler, after the
   counts are read and just after an unprofiled solve of its kind, for the
   device time of each kernel and the device's busy share of the solve.
6. The consolidation verdicts: ``TorchScheduler(device="cuda")``'s
   ``evaluate_removals`` and ``evaluate_population`` on two problems, both
   objectives.  ``sweep``: the cluster of ``bench.py``'s configs 4b/4c (560
   pods of two sizes over the 4 and 8 vCPU catalog, opened by a cold solve
   on the card: about 60 live nodes, Kp 1024, the resident scan), every
   node a candidate; the singles, then a ``SearchPlan`` pass at population
   320, 2 rounds.  ``live``: 2,000 live nodes of ``std1.large`` (4 vCPU)
   of config 2's general pool, each holding 1-4 seeded pods of those two
   sizes, the universe its 64 least-loaded nodes (Kp 4096, the cluster
   scan); the 64 singles and the 64 drop-one subsets, then a pass at
   population 512, 2 rounds.  The launch counters are set to 0 just before
   the drive and read just after: the batched scan of each problem's
   shapes, each of `verdict_rows`' three launches (``verdict_summary``,
   ``verdict_configs``, ``verdict_write``) and ``population_pairs`` (the
   prologue) must have launched, ``ffd_scan_global_batched`` not.  The
   decoded verdicts (and the plan's proposals and pick) must equal the
   same calls through ``device="cpu"``.  Then on the same card tensors
   each kernel against its plain version, bit for bit: the batched scan
   (full outputs; at ``live`` also through the global scan),
   ``population_prologue``'s three outputs and the [B, 6] rows; then the
   tie and edge cases (``testing.verdict_tie_arrays``: equal masked prices
   across warps and config tiles, elements in two groups, an element with
   every config masked, one with no new slot, one with many; Gp 8 and 40;
   Cp 6, 1000 and 8192 at the live problem's Kp 4096 and B 512; next0 0
   and K), both objectives, through ``removal_verdicts`` and through
   `verdict_rows` at next0, 0 and K; the prologue with U and Gp past its
   block (``testing.population_arrays``).  Each kernel's device time
   (torch.profiler; `verdict_rows`' launches and their sum, and its
   CUDA-event time a back-to-back call), its bound and the batched scan's
   latency floor (class steps x (barrier + 2 / 32 L2 loads) x ceil(B /
   elements the card runs at once)), the plain versions' times,
   ``torch.argsort(stable=True)`` beside the prologue, the p50 of both
   entry points with their last phases, and the count of ``needs_host``
   verdicts.
7. The operator: the port's provisioning loop through its normal entry
   point, ``testing.Environment(device="cuda")`` (the `Operator` over the
   fake cloud, a fake clock and the fake kubelet) over config 2's catalog
   with its ``general`` and ``dedicated`` pools and a default NodeClass.
   All 10,000 of config 2's pods go into the store and the run ticks
   (``env.step``, 2 s of fake clock) until every pod is bound; then 5
   churn rounds each replace 100 bound pods by new pods of their shapes
   (an arrival tick, then the tick that solves and binds them).  The
   launch counters are set to 0 just before the drive and read just after:
   every solve must run on the card (``last_kernel == "cuda_ffd"``) and
   launch ``choose_config`` and the scan `fused_packer.scan_kernel` picks
   for its resident state, ``ffd_scan_global`` never; every pod must be
   bound; no controller may have failed a reconcile
   (``karpenter_controller_reconcile_errors_total``); and the run's
   NodeClaims, Nodes, bindings and nominations, cloud calls, ledger stream
   and solver counters (`testing.operator_state`) must equal those of the
   same drive on the port's CPU operator.  One line a tick: the
   operator's tick ms, each controller's ms, the solve's kind (cold, hit,
   delta) and phases, the garbage collector's ms in the step, and the
   device observatory's tick section with its
   launches by function, new signatures, transfer bytes by site and
   resident updates; then the p50 tick of each kind and the device busy
   share of the last churn round's solve tick, profiled (device-side
   events only).
Then it prints the kernels JSON line (every kernel, the old and the new;
``operator_launches`` is phase 7's count), the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# published peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
WARMUP_SOLVES, TIMED_SOLVES = 2, 10
SOLVE_KINDS = ("cold", "hit", "delta")  # phase 5's solves of each problem
DELTA_PODS = 100  # pods replaced each delta tick: 1 % of 10,000
DELTA_NODES = 10  # live nodes whose usage changes each delta tick
KERNEL_SOURCE = "karpenter_tpu_torch/csrc/ffd_pack.cu"
REPLACES = "karpenter_tpu/ops/pallas_packer.py:99"  # _pack_step
SCAN_KERNELS = ("ffd_scan", "ffd_scan_global", "ffd_scan_cluster")
# the consolidation verdicts' kernels (phase 6): the scans with the batch
# axis, counted apart from the solve's, the three launches of
# `verdict_rows` and the one of `population_prologue`
VERDICT_ROWS = ("verdict_summary", "verdict_configs", "verdict_write")
VERDICT_KERNELS = ("ffd_scan_batched", "ffd_scan_cluster_batched",
                   "ffd_scan_global_batched", *VERDICT_ROWS, "population_pairs")
# the wrapper (the function held to its plain version) of each verdict launch
VERDICT_FUNCTION = {**{k: "verdict_rows" for k in VERDICT_ROWS},
                    "population_pairs": "population_prologue"}
KERNELS = ("choose_config", *SCAN_KERNELS, *VERDICT_KERNELS)
LIVE_NODES = 2000  # phase 5's live cluster: 2,000 + 256 slots -> 4096
# the problem each kernel's row of the kernels line is measured at: the one
# whose solves launch it (the global scan: where it ran before the cluster
# scan took that shape)
ROW_PROBLEM = {"choose_config": "config2", "ffd_scan": "config2",
               "ffd_scan_global": "config2_live", "ffd_scan_cluster": "config2_live",
               "ffd_scan_batched": "sweep", "ffd_scan_cluster_batched": "live",
               "ffd_scan_global_batched": "live",
               **{k: "live" for k in VERDICT_FUNCTION}}
OBJECTIVES = ("nodes", "cost")
# phase 6: the sweep's pods, the live cluster's nodes and universe, each
# problem's population and rounds, the plan's seed, timed repeats
# the JAX package's device functions each verdict kernel takes the place of
# (jitted XLA functions, not Pallas kernels): the batched scans run
# removal_verdict_kernel's vmapped _pack_core, verdict_rows' launches its
# _verdict_row epilogue, population_pairs population_verdict_kernel's
# prologue
VERDICT_REPLACES = {
    "ffd_scan_batched": "karpenter_tpu/ops/packer.py:615",
    "ffd_scan_cluster_batched": "karpenter_tpu/ops/packer.py:615",
    "ffd_scan_global_batched": "karpenter_tpu/ops/packer.py:615",
    **{k: "karpenter_tpu/ops/packer.py:525" for k in VERDICT_ROWS},
    "population_pairs": "karpenter_tpu/ops/packer.py:686",
}
SWEEP_PODS = 560
LIVE_UNIVERSE = 64
POPULATION = {"sweep": 320, "live": 512}
SEARCH_ROUNDS, SEARCH_SEED, VERDICT_SEED = 2, 7, 8
TIMED_VERDICTS = 5
# the scan each verdict problem's shapes pick, and its batched launch count
VERDICT_SCAN = {"sweep": "ffd_scan", "live": "ffd_scan_cluster"}
L2_PROBE_BYTES = 8 << 20  # pointer-chase buffer: past L1, well inside L2
# the kernels whose registers phase 2 prints and whose spills fail the run
SPILL_CHECKED = ("choose_config", *VERDICT_ROWS, "population_pairs")
# phase 7: the operator over config 2's catalog and all of its pods, ticks
# of fake clock, the ticks allowed until every pod is bound, the churn
OPERATOR_PODS = 10_000
TICK_S = 2.0
MAX_BIND_TICKS = 12
CHURN_ROUNDS, CHURN_PODS, CHURN_SEED = 5, 100, 3
# the ported controllers, in the operator's order
CONTROLLERS = ("nodeclass", "provisioner", "lifecycle", "termination", "link",
               "garbagecollection", "tagging")


LAST_PHASE = 7


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def parse_through(argv) -> int:
    """The last phase to run: ``--through N`` (N = 1-6) stops after phase
    N; no argument runs them all.  Anything else exits 2."""
    if not argv:
        return LAST_PHASE
    if len(argv) == 2 and argv[0] == "--through" and argv[1] in ("1", "2", "3", "4", "5", "6"):
        return int(argv[1])
    print("usage: python3 chip_smoke.py [--through N]  (N = 1-6: stop after phase N)",
          file=sys.stderr, flush=True)
    raise SystemExit(2)


def phase_done(phase: int, through: int) -> None:
    """Ends a partial run after ``phase``: exit 3, no result line."""
    if phase >= through:
        print(f"chip_smoke: stopped after phase {phase} (partial run)",
              file=sys.stderr, flush=True)
        raise SystemExit(3)


def ptxas_resources(log: str):
    """``{kernel symbol: (registers, spill store bytes, spill load bytes)}``
    from an ``nvcc -Xptxas -v`` log."""
    import re

    out, current, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out[current] = (int(m.group(1)), *spills)
            current, spills = None, (0, 0)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def problems():
    from karpenter_tpu_torch import testing as T

    pools, inv, pods = T.heterogeneous_problem()
    pool, types, fpods = T.flagship_problem()
    return {
        "config2": (pools, inv, pods, []),
        "flagship": ([pool], {pool.name: types}, fpods, []),
        "config2_live": (pools, inv, pods, T.live_cluster(LIVE_NODES)),
    }


def compiled(spec):
    from karpenter_tpu_torch.ops.tensorize import compile_problem

    pools, inv, pods, existing = spec
    return compile_problem(pods, pools, inv, existing=existing)


def max_abs_err(torch, got, want) -> float:
    """Largest absolute difference over paired outputs; a float output must
    also match bit for bit, or the error is reported as infinite."""
    err = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if a.dtype == torch.float32 and not torch.equal(
            a.view(torch.int32), b.view(torch.int32)
        ):
            return float("inf")
        if a.numel():
            err = max(err, (a.double() - b.double()).abs().max().item())
    return err


def scan_step_model(kernel: str, K: int):
    """``(block barriers, exposed dependent L2 loads)`` per class step of a
    scan kernel of ffd_pack.cu.

    ``ffd_scan_global``: one barrier after loading the class's req row,
    three per chunk of its block scan, three in each of its two block sums;
    it waits on the req row and on feas[g, cfg[k]] gathered through the
    slot's config (loads whose address or data the previous step decides
    and that no earlier step touched).

    ``ffd_scan`` (resident): one barrier, to exchange the warp totals (a
    second only where an int32 sum can wrap, which the bench problems never
    do).  Its feasibility rows arrive in shared memory ahead of the step;
    its class rows arrive a tile of ``SCAN_TILE`` classes at a time, whose
    load waits on two dependent L2 loads (c_star, then the alloc row), so
    2 / SCAN_TILE per step.

    ``ffd_scan_cluster``: the resident step with its one barrier a cluster
    barrier (the warp totals exchanged through the cluster's shared
    memory), and the same 2 / SCAN_TILE loads."""
    from karpenter_tpu_torch.ops.fused_packer import SCAN_TILE, scan_threads

    if kernel == "ffd_scan_global":
        return 1 + 3 * -(-K // scan_threads(K)) + 3 + 3, 2
    if kernel in ("ffd_scan", "ffd_scan_cluster"):
        return 1, 2 / SCAN_TILE
    raise ValueError(f"no step model for {kernel}")


def kernel_bounds(args, take, node_cfg):
    """Least milliseconds each kernel could take on this card for this
    run's inputs: max(bytes moved / HBM rate, operations / f32 rate).
    Every input the function needs is read once and every output written
    once; where the need depends on the data (which slots are open, which
    configs a class fits) only what this run's data needs is counted."""
    import numpy as np

    host = lambda t: t if isinstance(t, int) else t.cpu().numpy()
    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, _next0, sig0) = (host(a) for a in args)
    take, node_cfg = host(take), host(node_cfg)
    G, R = req.shape
    K = used0.shape[0]
    ru = (req > 0).sum(axis=1)  # axes each class requests

    # choose_config: every feasibility bit and openable/price entry decides
    # the argmin; the capacity (4 ops per requested axis: div, add, floor,
    # min) and the score (4: clamp, div, add, compare) only where the class
    # fits and the config can open; 2 ops per pair for the mask and argmin
    # select, 1 per config for the price ceiling
    fo = feas & openable[None, :]
    ops_choose = int((fo.sum(axis=1) * (4 * ru + 4)).sum()) + 2 * G * fo.shape[1] + fo.shape[1]
    bytes_choose = (
        feas.nbytes + openable.nbytes + price.nbytes + req.nbytes + maxper.nbytes
        + int(fo.any(axis=0).sum()) * R * 4  # alloc rows of fitting configs
        + 3 * G * 4  # c_star, new_ok, per
    )

    # ffd_scan: slot k is open at class g if it was filled before the scan
    # or first took pods at a class before g; a class reads feas and the
    # slot's alloc row only for open slots, once per distinct config, and
    # its signature counter only where it fits
    taken = take > 0
    first = np.where(taken.any(axis=0), taken.argmax(axis=0), G)
    opened_at = np.where(cfg0 >= 0, -1, first)
    open_ = np.arange(G)[:, None] > opened_at[None, :]  # [G, K]
    cfg_k = np.maximum(node_cfg, 0)
    fits = open_ & feas[:, cfg_k]
    feas_pairs = sum(len(np.unique(cfg_k[open_[g]])) for g in range(G))
    alloc_rows = len(np.unique(cfg_k[fits.any(axis=0)]))
    gi, ki = np.nonzero(fits)
    sig_pairs = len(np.unique(slot[gi].astype(np.int64) * K + ki))
    # per fitting slot: capacity (4 per requested axis) plus the signature
    # room, min, prefix and clip (5); per slot that takes pods: the usage
    # update (mul + add per requested axis) and the take, pod and
    # signature counts (3)
    ops_scan = int((fits * (4 * ru + 5)[:, None]).sum()
                   + (taken * (2 * ru + 3)[:, None]).sum())
    bytes_scan = (
        req.nbytes + cnt.nbytes + maxper.nbytes + slot.nbytes + 3 * G * 4
        + feas_pairs + alloc_rows * R * 4 + sig_pairs * 4
        + used0.nbytes + cfg0.nbytes + npods0.nbytes
        + take.nbytes + G * 4 + 2 * K * 4 + K * R * 4  # outputs
    )
    out = {}
    for name, b, o in (
        ("choose_config", bytes_choose, ops_choose),
        ("ffd_scan", bytes_scan, ops_scan),
    ):
        t_bytes, t_ops = b / HBM_BYTES_PER_S * 1e3, o / F32_OPS_PER_S * 1e3
        out[name] = {
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(b),
            "operations": int(o),
        }
    return out


def scan_latency_floor_ms(kernel: str, G: int, K: int, barrier_us: float,
                          l2_us: float) -> float:
    """A scan kernel's floor as a chain of dependent class steps: each step
    passes its barriers and waits on its dependent L2 loads in turn."""
    barriers, loads = scan_step_model(kernel, K)
    return G * (barriers * barrier_us + loads * l2_us) / 1e3


def probe_latencies(torch, threads, clusters):
    """``({threads: barrier round trip}, {(ctas, threads): cluster barrier
    round trip}, dependent L2 load round trip)`` in microseconds: the
    barrier of one block at each thread count in ``threads``, the
    exchange and barrier of one cluster at each (size, threads) in
    ``clusters``; each from two launches of csrc/latency_probe.cu at
    different step counts (the difference cancels the launch)."""
    import ctypes

    import numpy as np

    from karpenter_tpu_torch.ops import _build

    lib = _build.load("latency_probe")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_barrier.argtypes, lib.probe_barrier.restype = [I, I, P, P], I
    lib.probe_chase.argtypes, lib.probe_chase.restype = [P, I, P, P], I
    lib.probe_cluster_barrier.argtypes = [I, I, I, P, P]
    lib.probe_cluster_barrier.restype = I
    dev = torch.device("cuda")
    out = torch.empty(8 * 1024, dtype=torch.int32, device=dev)
    lines = L2_PROBE_BYTES // 128
    order = np.random.RandomState(0).permutation(lines)
    chain = np.zeros(lines * 32, np.int32)
    chain[order * 32] = np.roll(order, -1) * 32  # one cycle over every line
    chain = torch.from_numpy(chain).to(dev)

    def launched(err):
        if err != 0:
            fail(f"latency probe launch failed with CUDA error {err}")

    def per_step_us(launch, n1, n2):
        stream = torch.cuda.current_stream().cuda_stream
        t = lambda n: cuda_ms(torch, lambda: launched(launch(n, stream)), iters=3, warmup=1)
        return (t(n2) - t(n1)) / (n2 - n1) * 1e3

    barrier_us = {
        b: per_step_us(
            lambda n, st, b=b: lib.probe_barrier(b, n, out.data_ptr(), st), 20000, 220000)
        for b in threads
    }
    cluster_us = {
        (c, b): per_step_us(
            lambda n, st, c=c, b=b: lib.probe_cluster_barrier(c, b, n, out.data_ptr(), st),
            20000, 220000)
        for c, b in clusters
    }
    l2_us = per_step_us(
        lambda n, st: lib.probe_chase(chain.data_ptr(), n, out.data_ptr(), st),
        lines, 4 * lines)
    return barrier_us, cluster_us, l2_us


def pack_shapes(args):
    """``(K, R, S, C)`` of a pack's arguments, as `fused_packer.scan_kernel`
    takes them."""
    return args[8].shape[0], args[0].shape[1], args[12].shape[0], args[5].shape[0]


def other_cluster_sizes(K, R, S, C):
    """The cluster sizes other than the one the shape rule picks that hold
    these shapes."""
    from karpenter_tpu_torch.ops import fused_packer as F

    picked = (F.cluster_layout(K, R, S, C) or (None,))[0]
    return [n for n in F.CLUSTER_SIZES if n != picked and F.cluster_layout(K, R, S, C, n)]


def compare_kernels(torch, args, picked, extra):
    """Phase 3 on one problem's padded card tensors, both objectives:
    `choose_config` and the scan against the plain versions, the scan
    through `fused_packer.ffd_scan` (whose shape rule must pick
    ``picked``) and through each ``(label, wrapper, kernel)`` of ``extra``.
    Each scan call must launch the kernel expected of it.  Returns the
    largest error per kernel and the nodes objective's scan outputs."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    K = used0.shape[0]
    if F.scan_kernel(*pack_shapes(args)) != picked:
        fail(f"the shape rule picks {F.scan_kernel(*pack_shapes(args))} at K={K}, "
             f"expected {picked}")
    scans = [(picked, F.ffd_scan, picked), *extra]
    errs, nodes_out = {}, None
    for objective in ("nodes", "cost"):
        chosen = F.choose_config(req, maxper, feas, alloc, price, openable, objective)
        torch.cuda.synchronize()
        plain = P.choose_config_reference(
            req, maxper, feas, alloc, price, openable, objective
        )
        want = P.ffd_scan_reference(req, cnt, maxper, slot, feas, alloc, *plain,
                                    used0, cfg0, npods0, next0, sig0)
        torch.cuda.synchronize()
        e1 = max_abs_err(torch, chosen, plain)
        errs["choose_config"] = max(errs.get("choose_config", 0.0), e1)
        for label, scan, expect in scans:
            before = dict(F.LAUNCHES)
            got = scan(req, cnt, maxper, slot, feas, alloc, *chosen,
                       used0, cfg0, npods0, next0, sig0)
            torch.cuda.synchronize()
            ran = [k for k in SCAN_KERNELS if F.LAUNCHES[k] != before[k]]
            if ran != [expect]:
                fail(f"{label} at K={K} launched {ran}, expected {expect}")
            e2 = max_abs_err(torch, got, want)
            print(f"  {objective}: choose_config max_abs_err={e1} {label} "
                  f"max_abs_err={e2} placed={int(got[0].sum())} "
                  f"leftover={int(got[1].sum())} nodes={int((got[2] >= 0).sum())}")
            if e1 != 0 or e2 != 0:
                fail(f"kernel disagrees with its plain version ({objective})")
            errs[expect] = max(errs.get(expect, 0.0), e2)
            if objective == "nodes" and nodes_out is None:
                nodes_out = got
    return errs, nodes_out


def compare_choose(torch, name, args):
    """Phase 3's choice cases: `choose_config` against the plain version on
    one case's card tensors, both objectives, bit for bit, each call
    launching the kernel once.  Returns the largest error."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    req, _, maxper, _, feas, alloc, price, openable = args[:8]
    choice = (req, maxper, feas, alloc, price, openable)
    err = 0.0
    for objective in ("nodes", "cost"):
        want = P.choose_config_reference(*choice, objective)
        before = dict(F.LAUNCHES)
        got = F.choose_config(*choice, objective)
        torch.cuda.synchronize()
        moved = {k: F.LAUNCHES[k] - before[k] for k in F.LAUNCHES if F.LAUNCHES[k] != before[k]}
        if moved != {"choose_config": 1}:
            fail(f"{name}: choose_config launched {moved}, expected choose_config once")
        e = max_abs_err(torch, got, want)
        err = max(err, e)
        if e != 0:
            fail(f"{name}: choose_config disagrees with its plain version ({objective}): "
                 f"max_abs_err={e}")
    print(f"  {name} Gp={req.shape[0]} Cp={alloc.shape[0]}: choose_config equals the plain "
          f"version (nodes and cost)")
    return err


def _device_us(ev) -> float:
    dev_us = getattr(ev, "self_device_time_total", None)
    return dev_us if dev_us is not None else getattr(ev, "self_cuda_time_total", 0.0)


def profiled_launches_ms(torch, fn, kernels, iters: int) -> dict:
    """Mean device milliseconds per launch of each kernel of ``kernels``
    over ``iters`` calls of ``fn``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for kernel in kernels:
        total_us, count = 0.0, 0
        for ev in events:
            if f"{kernel}_kernel" in ev.key and _device_us(ev) > 0:
                total_us += _device_us(ev)
                count += ev.count
        if not count:
            fail(f"torch.profiler saw no device time of {kernel}")
        out[kernel] = total_us / count / 1e3
    return out


def profiled_ms(torch, fn, kernel: str, iters: int):
    """Mean device milliseconds per launch of ``kernel`` over ``iters``
    calls of ``fn``, from torch.profiler."""
    return profiled_launches_ms(torch, fn, (kernel,), iters)[kernel]


def time_kernels(torch, args, scan_turns: bool = False):
    """Phase 4: per kernel at one problem's shapes (nodes objective), its
    device ms per launch (profiler), its CUDA-event ms per call over
    back-to-back calls (the wrapper's host enqueue included where it is
    slower than the kernel), its plain version's CUDA-event ms, and the
    profiler readings it was averaged from.  The scan is the one
    `fused_packer.scan_kernel` picks for the shapes; with ``scan_turns``
    the global scan is timed too, in turns with it (global, picked,
    picked, global), and where the picked scan is the cluster one, each
    other cluster size that holds the shapes between them (global,
    picked, others, others reversed, picked, global), each under the
    label ``ffd_scan_cluster ctas=N``."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    chosen = F.choose_config(req, maxper, feas, alloc, price, openable)
    scan_args = (req, cnt, maxper, slot, feas, alloc, *chosen,
                 used0, cfg0, npods0, next0, sig0)
    choose = lambda: F.choose_config(req, maxper, feas, alloc, price, openable)
    shapes = pack_shapes(args)
    picked = F.scan_kernel(*shapes)
    # label -> (call, kernel symbol)
    scans = {picked: (lambda: F.ffd_scan(*scan_args), picked)}
    order = [picked]
    if scan_turns:
        if picked == "ffd_scan_global":
            fail("scan turns need the resident or cluster scan's shapes")
        scans["ffd_scan_global"] = (lambda: F.ffd_scan_global(*scan_args), "ffd_scan_global")
        others = []
        if picked == "ffd_scan_cluster":
            for n in other_cluster_sizes(*shapes):
                others.append(f"ffd_scan_cluster ctas={n}")
                scans[others[-1]] = (
                    lambda n=n: F.ffd_scan_cluster(*scan_args, ctas=n), "ffd_scan_cluster")
        order = ["ffd_scan_global", picked, *others, *others[::-1], picked, "ffd_scan_global"]
    readings = {k: [] for k in scans}
    for k in order:
        fn, symbol = scans[k]
        readings[k].append(profiled_ms(torch, fn, symbol, iters=50))
    plain_scan = cuda_ms(torch, lambda: P.ffd_scan_reference(*scan_args),
                         iters=3, warmup=1)
    choose_ms = profiled_ms(torch, choose, "choose_config", iters=200)
    out = {"choose_config": (
        choose_ms,
        cuda_ms(torch, choose, iters=200),
        cuda_ms(torch, lambda: P.choose_config_reference(
            req, maxper, feas, alloc, price, openable), iters=20),
        [choose_ms],
    )}
    for k, (fn, _) in scans.items():
        out[k] = (statistics.mean(readings[k]), cuda_ms(torch, fn, iters=50),
                  plain_scan, readings[k])
    return out


def canonical(result):
    nodes = sorted(
        (vn.pool.name, tuple(t.name for t in vn.feasible_types),
         tuple(sorted(vn.zone_options())), tuple(sorted(p.name for p in vn.pods)))
        for vn in result.new_nodes
    )
    return nodes, sorted(result.existing_placements.items()), sorted(result.unschedulable)


def profile_solve(torch, solve, pods):
    """One more solve (``solve(pods)``) under torch.profiler: the launches
    the port's wrappers counted during it, the device time of each of the
    port's kernels and of all device work (kernels, copies and fills: the
    device-side events only, so no CPU op's attributed time counts twice),
    the device events that took the most of it, and the solve's wall time.
    Returns None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from karpenter_tpu_torch.ops import fused_packer as F

    before = dict(F.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(pods)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {k: 0.0 for k in KERNELS}
    device_events = []
    for ev in prof.key_averages():
        dev_us = _device_us(ev)
        if ev.device_type != DeviceType.CUDA or dev_us <= 0:
            continue
        device_events.append((dev_us, ev.key, ev.count))
        for k in per_kernel:
            if f"{k}_kernel" in ev.key:
                per_kernel[k] += dev_us
    busy_us = sum(us for us, _, _ in device_events)
    if busy_us <= 0:
        return None
    return {
        "wall_ms": wall_ms,
        "launches": {k: F.LAUNCHES[k] - before[k] for k in KERNELS},
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "kernel_device_ms": {k: v / 1e3 for k, v in per_kernel.items()},
        "top_device_events": [
            {"name": name[:60], "count": n, "ms": us / 1e3}
            for us, name, n in sorted(device_events, reverse=True)[:6]
        ],
    }


def main_path_state(torch, spec):
    """The resident state a cold ``TorchScheduler.solve`` on the card seeds:
    its tensors are the pack arguments the main path gives the kernels."""
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pools, inv, pods, existing = spec
    sched = TorchScheduler(pools, inv, existing=existing, device="cuda")
    sched.solve(pods)
    torch.cuda.synchronize()
    if not sched.last_resident:
        fail("a cold solve on the card seeded no resident state")
    return sched._resident.states[-1]


def cold_solve(sched, pods):
    """A cold solve on a long-lived scheduler: its compile cache and
    resident states are dropped first (its catalog stays built)."""
    sched._compile_cache.clear()
    sched._resident.states.clear()
    return sched.solve(pods)


def churn(rng, pods, existing):
    """One delta tick's input: ``DELTA_PODS`` pods leave the batch and as
    many new pod objects, with the shapes of pods of the batch, join its
    end (as pods arrive in a pending queue) and, on a live cluster,
    ``DELTA_NODES`` nodes' usage grows by a bound pod."""
    import dataclasses

    from karpenter_tpu_torch.api import Pod, Resources

    gone = set(rng.sample(range(len(pods)), DELTA_PODS))
    out = [p for i, p in enumerate(pods) if i not in gone]
    out += [dataclasses.replace(pods[rng.randrange(len(pods))], name="")
            for _ in range(DELTA_PODS)]
    for sn in rng.sample(existing, min(DELTA_NODES, len(existing))):
        bp = Pod(requests=Resources(cpu=0.25, memory="256Mi"), node_name=sn.name,
                 phase="Running")
        sn.pods = sn.pods + [bp]
        sn.used = sn.used + bp.requests
    return out


MIRRORS = ("req", "cnt", "feas", "alloc", "price", "openable", "used0", "npods0")


def check_mirrors(torch, name, st) -> None:
    """The resident state's card tensors against its host mirrors, bit for
    bit, and its slot configs against the live node count."""
    import numpy as np

    for m in MIRRORS:
        d, h = getattr(st, f"d_{m}").cpu().numpy(), getattr(st, f"h_{m}")
        if d.dtype == np.float32:
            d, h = d.view(np.int32), h.view(np.int32)
        if d.shape != h.shape or not np.array_equal(d, h):
            fail(f"{name}: resident d_{m} differs from its host mirror")
    E = len(st.live)
    cfg0 = np.full(st.Kp, -1, np.int32)
    cfg0[:E] = np.arange(st.fe, st.fe + E)
    if not np.array_equal(st.d_cfg0.cpu().numpy(), cfg0):
        fail(f"{name}: resident d_cfg0 is not the live slots' configs")


def placed_all(name, sched, result, n_pods) -> None:
    placed = sum(len(n.pods) for n in result.new_nodes) + len(result.existing_placements)
    if placed != n_pods or result.unschedulable:
        fail(f"{name}: placed {placed} of {n_pods} pods")
    if sched.last_kernel != "cuda_ffd" or sched.last_path != "tensor":
        fail(f"{name}: path {sched.last_path}/{sched.last_kernel}")


def cpu_equal(name, label, spec, pods, result) -> None:
    """The card's result against a cold CPU solve through the plain version
    of the same pods and live nodes."""
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pools, inv, _, existing = spec
    cpu = TorchScheduler(pools, inv, existing=existing, device="cpu").solve(pods)
    if canonical(cpu) != canonical(result):
        fail(f"{name}: the card's {label} solve differs from the CPU plain solve")
    print(f"    {label}: equals the CPU plain-version cold solve ({len(cpu.new_nodes)} nodes)")


def drive_solves(torch, name, spec, rng):
    """Phase 5 on one problem: warm-up + timed solves of each kind on one
    scheduler on the card, cold (compile cache and resident states dropped
    first), hit (the same pods again: a compile-cache hit that packs from
    the resident tensors) and delta (after each `churn`: the resident
    tensors absorb the diff).  Returns the scheduler, the last pods, and
    per kind the timed milliseconds and the last solve's phases."""
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pools, inv, pods, existing = spec
    sched = TorchScheduler(pools, inv, existing=existing, device="cuda")
    times = {kind: [] for kind in SOLVE_KINDS}
    phases = {}
    for kind in SOLVE_KINDS:
        last = None
        for i in range(WARMUP_SOLVES + TIMED_SOLVES):
            if kind == "delta":
                pods = churn(rng, pods, existing)
            hits = sched.compile_cache_hits
            t0 = time.perf_counter()
            result = cold_solve(sched, pods) if kind == "cold" else sched.solve(pods)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if i >= WARMUP_SOLVES:
                times[kind].append(ms)
            placed_all(name, sched, result, len(pods))
            hit = sched.compile_cache_hits > hits
            if kind != "cold" and not sched.last_resident:
                fail(f"{name}: a {kind} solve did not pack from the resident tensors")
            if (kind == "hit") != hit:
                fail(f"{name}: a {kind} solve was {'' if hit else 'not '}a compile-cache hit")
            if kind == "delta":
                if sched.last_delta_rows <= 0:
                    fail(f"{name}: a delta tick scattered {sched.last_delta_rows} rows")
                check_mirrors(torch, name, sched._resident.states[-1])
            last = result
        phases[kind] = dict(sched.last_phases)
        if kind == "cold":
            cpu_equal(name, "last cold", spec, pods, last)
            cold = canonical(last)
        elif kind == "hit" and canonical(last) != cold:
            fail(f"{name}: a compile-cache hit decoded another result than the cold solve")
    cpu_equal(name, "last delta", spec, pods, last)
    print(f"    after each delta tick the resident card tensors equal their host mirrors; "
          f"last delta scattered {sched.last_delta_rows} rows")
    return sched, pods, times, phases


# ---------------------------------------------------------------------------
# Phase 6: the consolidation verdicts
# ---------------------------------------------------------------------------


def verdict_specs(device: str = "cuda"):
    """Phase 6's problems: name -> dict of pools, inventory, existing nodes,
    the candidate universe, the removal subsets, node prices, the population
    and the rounds.  The sweep's nodes come from a cold port solve on
    ``device``."""
    from karpenter_tpu_torch import testing as T

    pools, inv, existing, cands = T.consolidation_sweep(SWEEP_PODS, device=device)
    def spec(pools, inv, existing, universe, subsets, name):
        node = {sn.name: sn for sn in existing}
        return dict(pools=pools, inventory=inv, existing=existing, universe=universe,
                    subsets=subsets, population=POPULATION[name],
                    prices=T.node_prices([node[c.node_name] for c in universe], inv))

    pools, inv, existing, cands = T.consolidation_sweep(SWEEP_PODS, device=device)
    specs = {"sweep": spec(pools, inv, existing, cands, [[c] for c in cands], "sweep")}
    hpools, hinv, _ = T.heterogeneous_problem(scale=1 / T.N_PODS)
    std = next(it for it in hinv["general"] if it.name == "std1.large")
    existing, cands = T.consolidation_cluster(VERDICT_SEED, LIVE_NODES, [std])
    universe = cands[:LIVE_UNIVERSE]
    drop_one = [[c for c in universe if c is not d] for d in universe]
    specs["live"] = spec(hpools, hinv, existing, universe,
                         [[c] for c in universe] + drop_one, "live")
    return specs


def key_masks(keys, width):
    import numpy as np

    m = np.zeros((len(keys), width), bool)
    for r, k in enumerate(keys):
        m[r, list(k)] = True
    return m


def drive_verdicts(sched, spec):
    """One consolidation pass on ``sched``: `evaluate_removals` on the
    problem's subsets, then a `SearchPlan` pass, each round through
    `evaluate_population`.  Returns the verdicts, each round's keys and
    verdicts, the plan's pick, and each call's wall ms and last phases."""
    from karpenter_tpu_torch.scheduling.popsearch import SearchPlan

    universe = spec["universe"]
    t0 = time.perf_counter()
    removals = sched.evaluate_removals(spec["subsets"], universe)
    calls = [("evaluate_removals", (time.perf_counter() - t0) * 1e3, dict(sched.last_phases))]
    plan = SearchPlan(len(universe), spec["prices"], [False] * len(universe),
                      spec["population"], SEARCH_ROUNDS, SEARCH_SEED)
    rounds = []
    while True:
        keys = plan.propose()
        if not keys:
            break
        t0 = time.perf_counter()
        got = sched.evaluate_population(key_masks(keys, len(universe)), universe)
        calls.append(("evaluate_population", (time.perf_counter() - t0) * 1e3,
                      dict(sched.last_phases)))
        plan.observe(keys, [(v.fits, v.replacement_price) for v in got])
        rounds.append((keys, got))
    return removals, rounds, plan.best(), calls


def verdict_inputs(torch, sched, spec):
    """The card tensors of one problem's verdict launches: the removal base,
    the removal batch ``(cnt_b, rm_b, perm_b)`` of its subsets, and the
    first population round's masks as the dispatch pads them."""
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.scheduling.popsearch import SearchPlan

    universe = spec["universe"]
    base = sched._removal_base(tuple(universe))
    if base.reason or base.empty or base.pop_reason:
        fail(f"the removal base refused the universe: {base.reason or base.pop_reason}")
    cnt, rm, perm, bad = sched._subset_batch(base, spec["subsets"])
    if bad:
        fail(f"{len(bad)} subsets outside the compiled universe")
    keys = SearchPlan(len(universe), spec["prices"], [False] * len(universe),
                      spec["population"], SEARCH_ROUNDS, SEARCH_SEED).propose()
    pp = P._bucket(len(keys), floor=sched.MIN_REMOVAL_BATCH)
    masks = key_masks(keys, base.cand_slot.shape[0])
    import numpy as np

    masks = np.concatenate([masks, np.zeros((pp - len(keys), masks.shape[1]), bool)])
    dev = torch.device("cuda")
    batch = P.to_device((cnt, rm, perm), dev)
    return base, batch, torch.from_numpy(masks).to(dev)


def compare_verdict_kernels(torch, name, base, batch, masks, objective):
    """Phase 6's bit-equality on one problem's card tensors: the batched
    scan on the removal batch and on the population (the global scan too at
    ``live``), `population_prologue`, and `verdict_rows` on each batch,
    against their plain versions.  Returns the largest error per kernel and
    the population's inputs and scan outputs (for the times and bounds)."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    (req, _, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = base.args
    chosen = F.choose_config(req, maxper, feas, alloc, price, openable, objective)
    pop = (base.cand_cnt, base.cand_slot, base.cand_occ, base.sort_rank, base.occ_span,
           masks, base.k_slots)
    got_pop = F.population_prologue(*pop)
    want_pop = P.population_prologue_reference(*pop)
    torch.cuda.synchronize()
    errs = {"population_prologue": max_abs_err(torch, got_pop, want_pop)}
    picked = F.scan_kernel(*pack_shapes(base.args))
    if picked != VERDICT_SCAN[name]:
        fail(f"{name}: the shape rule picks {picked}, expected {VERDICT_SCAN[name]}")
    shapes = (req.shape[0], alloc.shape[0], used0.shape[0], req.shape[1], sig0.shape[0])
    pop_outs = None
    for label, (cnt_b, rm_b, perm_b) in (("removal batch", batch), ("population", got_pop)):
        scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0,
                     sig0, cnt_b, rm_b, perm_b)
        outs = F.ffd_scan_batch(*scan_args)
        want = P.ffd_scan_batch_reference(*scan_args)
        torch.cuda.synchronize()
        scans = [(f"{picked}_batched", outs)]
        if name == "live":
            g = F._launch_global((req, cnt_b[0], *scan_args[1:13]), shapes,
                                 (perm_b.shape[0], perm_b, cnt_b, rm_b))
            torch.cuda.synchronize()
            scans.append(("ffd_scan_global_batched", g))
        for k, got in scans:
            errs[k] = max(errs.get(k, 0.0), max_abs_err(torch, got, want))
        tail = (perm_b, feas, alloc, price, openable, base.pool_id, base.zone_id, base.ct_id,
                base.compactable, next0)
        rows = F.verdict_rows(*outs, *tail)
        want_rows = P.verdict_rows_reference(*want, *tail)
        torch.cuda.synchronize()
        errs["verdict_rows"] = max(errs.get("verdict_rows", 0.0),
                                   max_abs_err(torch, [rows], [want_rows]))
        print(f"  {name} {objective} {label}: B={perm_b.shape[0]} Gp={req.shape[0]} "
              f"Kp={used0.shape[0]} Cp={alloc.shape[0]} R={req.shape[1]}: "
              + " ".join(f"{k} max_abs_err={v!r}" for k, v in sorted(errs.items())))
        if label == "population":
            pop_outs = (scan_args, outs, tail)
    if any(v != 0 for v in errs.values()):
        fail(f"{name} {objective}: a verdict kernel disagrees with its plain version: {errs}")
    return errs, pop, pop_outs


def batched_scan_bound(torch, scan_args, outs):
    """The batched scan's least time for this run's inputs: the base's
    inputs read once (feasibility and alloc rows only where a slot the
    element has open meets the class), each element's batch rows, every
    output written once; operations as `kernel_bounds` counts them, summed
    over the elements."""
    (req, maxper, slot, feas, alloc, c_star, new_ok, per, used0, cfg0, npods0, _next0,
     sig0, cnt_b, rm_b, perm_b) = scan_args
    take, leftover, node_cfg, node_pods, node_used = outs
    B, G, K = take.shape
    C = feas.shape[1]
    pl = perm_b.long()
    taken = take > 0
    gi = torch.arange(G, device=take.device)
    first = torch.where(taken.any(1), taken.int().argmax(1), G)  # [B, K]
    cfg_in = torch.where(rm_b, -1, cfg0[None, :])
    opened_at = torch.where(cfg_in >= 0, -1, first)
    open_ = gi[None, :, None] > opened_at[:, None, :]  # [B, G, K]
    cfg_k = node_cfg.clamp(min=0).long()
    fits = open_ & feas[pl].gather(2, cfg_k[:, None, :].expand(B, G, K))
    ru = (req > 0).sum(1)[pl]  # [B, G]
    ops = int((fits * (4 * ru + 5)[:, :, None]).sum()) + int((taken * (2 * ru + 3)[:, :, None]).sum())
    pairs = (pl[:, :, None] * C + cfg_k[:, None, :])[open_]
    feas_bytes = int(torch.unique(pairs).numel())
    alloc_rows = int(torch.unique(cfg_k[:, None, :].expand(B, G, K)[fits]).numel())
    sig_pairs = int(torch.unique((slot[pl].long()[:, :, None] * K
                                  + torch.arange(K, device=take.device))[fits]).numel())
    nb = lambda t: t.numel() * t.element_size()
    byts = (nb(req) + nb(maxper) + nb(slot) + 3 * G * 4 + feas_bytes + alloc_rows * alloc.shape[1] * 4
            + sig_pairs * 4 + nb(used0) + nb(cfg0) + nb(npods0) + nb(cnt_b) + nb(rm_b) + nb(perm_b)
            + sum(nb(t) for t in outs))
    return _bound(byts, ops)


def _bound(byts: int, ops: int) -> dict:
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(byts), "operations": int(ops)}


def verdict_rows_bound(torch, outs, tail, rows):
    """`verdict_rows`' least time for this run's data.  Bytes: each element
    reads its leftovers, the pod counts of the slots past next0, the take
    column and usage row of each new slot and of k_star, its class order;
    the config arrays and the feasibility rows of the classes on new slots
    are read once.  Operations, as the data needs them: per element a test
    per window slot and a class test per new slot; per config the slack add
    of each axis; per (element, config) pair the openable test and the
    three key compares; where the config is openable with the element's
    c_star key, the fit compare of each axis, a feasibility test per class
    on k_star and the argmin's compare and select; where the element's row
    reads `hold` (new_count >= 2, at most one non-donor), per openable
    config the compare of each axis, a feasibility test per class on a new
    slot and the or.  ``parts`` splits the bytes and operations over the
    three launches: the per-element reads and the slot and class tests
    (`verdict_summary`), the config arrays, the feasibility rows and the
    per-config tests (`verdict_configs`), the rows (`verdict_write`)."""
    take, leftover, node_cfg, node_pods, node_used = outs
    (perm_b, feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable, next0) = tail
    B, G, K = take.shape
    C, R = alloc.shape
    new = rows[:, 1].long()  # new slots per element
    n0 = int(next0)
    taken = take > 0
    newmask = (torch.arange(K, device=take.device) >= n0)[None, :] & (node_pods > 0)  # [B, K]
    on_any = (taken & newmask[:, None, :]).any(2)  # [B, G]
    feas_rows = int(torch.unique(perm_b.long()[on_any]).numel())
    k_star = newmask.to(torch.uint8).argmax(1)
    cs = node_cfg.gather(1, k_star[:, None])[:, 0].clamp(min=0).long()
    on_k = taken.gather(2, k_star[:, None, None].expand(B, G, 1))[:, :, 0].sum(1)  # [B]
    same = ((pool_id[None, :] == pool_id[cs][:, None]) & (zone_id[None, :] == zone_id[cs][:, None])
            & (ct_id[None, :] == ct_id[cs][:, None]) & openable[None, :])  # [B, C]
    bad = (taken & ~compactable[perm_b.long()][:, :, None]).any(1)  # [B, K]
    non_donors = (newmask & ((node_pods > 8) | bad)).sum(1)
    hold = (new >= 2) & (non_donors <= 1)
    argmin_ops = int((same.sum(1) * (R + on_k + 2)).sum())
    hold_ops = int((hold * (R + on_any.sum(1) + 1)).sum()) * int(openable.sum())
    summary = (B * G * 4 + B * (K - n0) * 4 + B * 4 + int((new + 1).sum()) * (G + R) * 4
               + B * G * 4 + G, B * (K - n0) + int(new.sum()) * G)
    configs = (feas_rows * C + C * (R * 4 + 4 + 1 + 12), C * R + 4 * B * C + argmin_ops + hold_ops)
    write = (B * 6 * 4, 0)
    parts = dict(zip(("verdict_summary", "verdict_configs", "verdict_write"),
                     (summary, configs, write)))
    out = _bound(sum(b for b, _ in parts.values()), sum(o for _, o in parts.values()))
    out["parts"] = {k: _bound(*v) for k, v in parts.items()}
    return out


def prologue_bound(pop, outs):
    """`population_prologue`'s least time: the masks and candidate tensors
    read once, the three outputs written once; per member and class a sum
    and a min over its selected candidates, and the rank's compares."""
    cand_cnt, cand_slot, cand_occ, sort_rank, _span, masks, k_slots = pop
    P, U = masks.shape
    G = sort_rank.shape[0]
    sel = int(masks.sum())
    nb = lambda t: t.numel() * t.element_size()
    byts = nb(masks) + nb(cand_cnt) + nb(cand_occ) + nb(cand_slot) + nb(sort_rank) + sum(nb(t) for t in outs)
    ops = sel * G * 2 + P * G * G + sel
    return _bound(byts, ops)


def time_verdict_kernels(torch, name, pop, pop_outs):
    """Device ms a launch (torch.profiler) of the batched scan, each launch
    of `verdict_rows` and `population_pairs` on the population's tensors,
    beside their plain versions (CUDA events) and, beside the prologue,
    ``torch.argsort(stable=True)`` of the same keys' shape; at ``live``
    the global batched scan's ms a launch by CUDA events.  Returns those,
    the argsort's ms and `verdict_rows`' CUDA-event ms per back-to-back
    call of the wrapper (its three launches and their host enqueue)."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    scan_args, outs, tail = pop_outs
    picked = VERDICT_SCAN[name]
    rows = lambda: F.verdict_rows(*outs, *tail)
    rows_ms = profiled_launches_ms(torch, rows, VERDICT_ROWS, iters=50)
    rows_plain = cuda_ms(torch, lambda: P.verdict_rows_reference(*outs, *tail), iters=2, warmup=1)
    out = {
        f"{picked}_batched": (
            profiled_ms(torch, lambda: F.ffd_scan_batch(*scan_args), picked, iters=20),
            cuda_ms(torch, lambda: P.ffd_scan_batch_reference(*scan_args), iters=2, warmup=1)),
        **{k: (rows_ms[k], rows_plain) for k in VERDICT_ROWS},
        "population_pairs": (
            profiled_ms(torch, lambda: F.population_prologue(*pop), "population_pairs",
                        iters=50),
            cuda_ms(torch, lambda: P.population_prologue_reference(*pop), iters=5, warmup=1)),
    }
    rows_events = cuda_ms(torch, rows, iters=50)
    if name == "live":
        shapes = (scan_args[0].shape[0], scan_args[4].shape[0], scan_args[8].shape[0],
                  scan_args[0].shape[1], scan_args[12].shape[0])
        cnt_b, rm_b, perm_b = scan_args[13:]
        glob = lambda: F._launch_global((scan_args[0], cnt_b[0], *scan_args[1:13]), shapes,
                                        (perm_b.shape[0], perm_b, cnt_b, rm_b))
        # CUDA events: the profiler records no device time for this
        # kernel's batched launches on the card (PERF.md §7)
        out["ffd_scan_global_batched"] = (cuda_ms(torch, glob, iters=3, warmup=1),
                                          out[f"{picked}_batched"][1])
    keys = torch.randint(0, 2**30, (pop[5].shape[0], pop[3].shape[0]), dtype=torch.int32,
                         device="cuda")
    argsort_ms = cuda_ms(torch, lambda: torch.argsort(keys, dim=1, stable=True), iters=50)
    return out, argsort_ms, rows_events


def batched_floor_ms(torch, name, base, B, barrier_us, l2_us) -> float:
    """The batched scan's latency floor: class steps x (its barrier + 2 /
    SCAN_TILE dependent L2 loads) x ceil(B / elements the card runs at
    once)."""
    from karpenter_tpu_torch.ops import fused_packer as F

    K, R, S, C = pack_shapes(base.args)
    G = base.args[0].shape[0]
    at_once = F.scan_concurrency(K, R, S, C)
    waves = -(-B // at_once)
    _, loads = scan_step_model(VERDICT_SCAN[name], K)
    ms = G * (barrier_us + loads * l2_us) * waves / 1e3
    print(f"  {name} {VERDICT_SCAN[name]}_batched latency floor: {G} steps x ({barrier_us!r} us "
          f"barrier + {loads} L2 x {l2_us!r} us) x {waves} waves ({B} elements, {at_once} at "
          f"once) = {ms!r} ms")
    return ms


def rows_in_groups(F, group: int, outs, tail):
    """`verdict_rows` with its config pass on element groups of ``group``
    (`fused_packer.verdict_group` replaced for the call)."""
    rule = F.verdict_group
    F.verdict_group = lambda *shape: group
    try:
        return F.verdict_rows(*outs, *tail)
    finally:
        F.verdict_group = rule


def compare_tie_cases(torch):
    """Phase 6's tie and edge cases, both objectives, kernels against their
    plain versions bit for bit: on each of `testing.VERDICT_TIE_CASES` the
    removal verdicts through the card (the choice, the batched scan the
    shapes pick, the three launches of `verdict_rows`, each once) and
    `verdict_rows` on the scan's outputs at next0, 0 and K (on the first
    case also on every element group); `population_prologue` on each of
    `testing.PROLOGUE_CASES` (one launch).  Returns the largest error per
    function."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    dev = torch.device("cuda")
    errs = {"verdict_rows": 0.0, "population_prologue": 0.0}
    first = next(iter(T.VERDICT_TIE_CASES))

    def moved_by(fn):
        before = dict(F.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: n - before[k] for k, n in F.LAUNCHES.items() if n != before[k]}

    for name, shape in T.VERDICT_TIE_CASES.items():
        a = P.to_device(T.verdict_tie_arrays(*shape), dev)
        (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
         pool_id, zone_id, ct_id, compactable, cnt_b, rm_b, perm_b) = a
        K, R = used0.shape
        scan = F.scan_kernel(K, R, sig0.shape[0], alloc.shape[0]) + "_batched"
        tail = (perm_b, feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable)
        for objective in OBJECTIVES:
            got, moved = moved_by(lambda: F.removal_verdicts(*a, objective=objective))
            if moved != {"choose_config": 1, scan: 1, **{k: 1 for k in VERDICT_ROWS}}:
                fail(f"{name}: removal_verdicts launched {moved}")
            e = max_abs_err(torch, [got], [P.removal_verdicts_reference(*a, objective=objective)])
            chosen = F.choose_config(req, maxper, feas, alloc, price, openable, objective)
            outs = F.ffd_scan_batch(req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0,
                                    next0, sig0, cnt_b, rm_b, perm_b)
            for n0 in sorted({next0, 0, K}):
                e = max(e, max_abs_err(torch, [F.verdict_rows(*outs, *tail, n0)],
                                       [P.verdict_rows_reference(*outs, *tail, n0)]))
            groups = F.verdict_groups(F.verdict_shape()[1]) if name == first else ()
            want = P.verdict_rows_reference(*outs, *tail, next0) if groups else None
            for group in groups:  # each element group of the config pass
                e = max(e, max_abs_err(torch, [rows_in_groups(F, group, outs, (*tail, next0))],
                                       [want]))
            print(f"  {name} {objective}: B={perm_b.shape[0]} Gp={req.shape[0]} Kp={K} "
                  f"Cp={alloc.shape[0]} next0={next0} ({scan}): verdict_rows max_abs_err={e!r} "
                  f"(also at next0 0 and K{', groups ' + repr(groups) if groups else ''}); rows "
                  f"{int(torch.isinf(got[:, 3]).sum())} +inf, "
                  f"c_min {sorted(set(got[:, 2].int().tolist()))[:6]}...")
            if e != 0:
                fail(f"{name} {objective}: verdict_rows disagrees with its plain version")
            errs["verdict_rows"] = max(errs["verdict_rows"], e)
    for U, G, K, Pm in T.PROLOGUE_CASES:
        a = P.to_device(T.population_arrays(U, G, K, Pm), dev)
        got, moved = moved_by(lambda: F.population_prologue(*a))
        if moved != {"population_pairs": 1}:
            fail(f"population_prologue at U {U} Gp {G} launched {moved}")
        e = max_abs_err(torch, got, P.population_prologue_reference(*a))
        errs["population_prologue"] = max(errs["population_prologue"], e)
        print(f"  population_prologue U={U} Gp={G} K={K} P={Pm}: max_abs_err={e!r}")
        if e != 0:
            fail(f"population_prologue disagrees with its plain version at U {U} Gp {G}")
    return errs


def verdict_phase(torch, card):
    """Phase 6 as the module docstring lists it.  Returns the kernels-line
    figures of its kernels."""
    import numpy as np

    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    specs = verdict_specs()
    for name, spec in specs.items():
        print(f"  {name}: {len(spec['existing'])} live nodes, universe {len(spec['universe'])}, "
              f"{len(spec['subsets'])} subsets, population {spec['population']}", flush=True)
    F.reset_launches()
    card_runs, per_problem = {}, {}
    for name, spec in specs.items():
        before = dict(F.LAUNCHES)
        for objective in OBJECTIVES:
            sched = TorchScheduler(spec["pools"], spec["inventory"], existing=spec["existing"],
                                   device="cuda", objective=objective)
            runs = [drive_verdicts(sched, spec)
                    for _ in range(1 + (TIMED_VERDICTS if objective == "nodes" else 0))]
            torch.cuda.synchronize()
            card_runs[(name, objective)] = (sched, runs)
        per_problem[name] = {k: F.LAUNCHES[k] - before[k] for k in VERDICT_KERNELS}
    launches = dict(F.LAUNCHES)
    print(f"  launches over the drive: {{{', '.join(f'{k!r}: {launches[k]}' for k in VERDICT_KERNELS)}}}"
          f", per problem {per_problem}")
    for name, got in per_problem.items():
        for k in (f"{VERDICT_SCAN[name]}_batched", *VERDICT_FUNCTION):
            if got[k] <= 0:
                fail(f"{name}: {k} launched no time in the drive")
        print(f"  {name}: the elements ran {VERDICT_SCAN[name]} (batched)")
    if launches["ffd_scan_global_batched"]:
        fail(f"ffd_scan_global_batched launched {launches['ffd_scan_global_batched']} times")
    # the same calls through the plain versions on the CPU
    for (name, objective), (sched, runs) in card_runs.items():
        spec = specs[name]
        cpu = TorchScheduler(spec["pools"], spec["inventory"], existing=spec["existing"],
                             device="cpu", objective=objective)
        want = drive_verdicts(cpu, spec)
        for got in runs:
            if got[0] != want[0] or [r[0] for r in got[1]] != [r[0] for r in want[1]] \
                    or [r[1] for r in got[1]] != [r[1] for r in want[1]] or got[2] != want[2]:
                fail(f"{name} {objective}: the card's verdicts differ from the CPU's")
        removals, rounds, best = runs[0][:3]
        verdicts = list(removals) + [v for _, vs in rounds for v in vs]
        print(f"  {name} {objective}: {len(verdicts)} verdicts equal the CPU's "
              f"({sum(v.fits for v in verdicts)} fit, "
              f"{sum(v.replacement_price > 0 for v in verdicts)} with a replacement, "
              f"needs_host {sum(v.needs_host for v in verdicts)}); plan best {best}")
        if objective == "nodes":
            for call in ("evaluate_removals", "evaluate_population"):
                ms = [c[1] for run in runs[1:] for c in run[3] if c[0] == call]
                last = [c[2] for c in runs[-1][3] if c[0] == call][-1]
                print(f"  {name} {call}: p50_ms={statistics.median(ms)!r} min_ms={min(ms)!r} "
                      f"max_ms={max(ms)!r} over {len(ms)} calls ({card}); last_phases_ms="
                      + json.dumps({k: v * 1e3 for k, v in sorted(last.items())}))
    # the kernels against their plain versions on the same card tensors
    errs, timing = {}, {}
    for name, spec in specs.items():
        for objective in OBJECTIVES:
            sched = card_runs[(name, objective)][0]
            base, batch, masks = verdict_inputs(torch, sched, spec)
            e, pop, pop_outs = compare_verdict_kernels(torch, name, base, batch, masks, objective)
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            if objective == "nodes":
                timing[name] = (base, pop, pop_outs)
    for k, v in compare_tie_cases(torch).items():
        errs[k] = max(errs.get(k, 0.0), v)
    # times, bounds and floors
    threads = sorted({F.scan_threads(pack_shapes(t[0].args)[0]) for t in timing.values()})
    K, R, S, C = pack_shapes(timing["live"][0].args)
    ctas, _, _ = F.cluster_layout(K, R, S, C)
    barrier_us, cluster_us, l2_us = probe_latencies(
        torch, threads, [(ctas, F.scan_threads(-(-K // ctas)))])
    figures = {}
    for name, (base, pop, pop_outs) in timing.items():
        t, argsort_ms, rows_events = time_verdict_kernels(torch, name, pop, pop_outs)
        scan_args, outs, tail = pop_outs
        rows = F.verdict_rows(*outs, *tail)
        b_scan = batched_scan_bound(torch, scan_args, outs)
        b_rows = verdict_rows_bound(torch, outs, tail, rows)
        bounds = {f"{VERDICT_SCAN[name]}_batched": b_scan, **b_rows["parts"],
                  "population_pairs": prologue_bound(pop, scan_args[13:16])}
        if name == "live":
            bounds["ffd_scan_global_batched"] = b_scan
        B = scan_args[15].shape[0]
        Kb = pack_shapes(base.args)[0]
        if VERDICT_SCAN[name] == "ffd_scan_cluster":
            b_us = cluster_us[(ctas, F.scan_threads(-(-Kb // ctas)))]
        else:
            b_us = barrier_us[F.scan_threads(Kb)]
        floor = batched_floor_ms(torch, name, base, B, b_us, l2_us)
        for k, (dev_ms, plain_ms) in t.items():
            print(f"  {name} {k}: kernel {dev_ms!r} ms device (profiler), plain {plain_ms!r} ms "
                  f"(CUDA events), bound {bounds[k]} ({card})")
            if ROW_PROBLEM[k] == name:
                figures[k] = dict(ms=dev_ms, plain_ms=plain_ms, bound=bounds[k],
                                  floor=floor if k == f"{VERDICT_SCAN[name]}_batched" else None,
                                  argsort_ms=argsort_ms if k == "population_pairs" else None)
        launch_sum = sum(t[k][0] for k in VERDICT_ROWS)
        group = F.verdict_group(B, tail[2].shape[0], F._sm_count(torch.cuda.current_device()),
                                *F.verdict_shape())
        print(f"  {name} verdict_rows (config pass on element groups of {group}): "
              f"{' + '.join(f'{k} {t[k][0]!r}' for k in VERDICT_ROWS)} = "
              f"{launch_sum!r} ms device (profiler); {rows_events!r} ms per back-to-back call of "
              f"the wrapper (CUDA events); bound {b_rows['bound_ms']!r} ms "
              f"({b_rows['bound_by']}) ({card})")
        print(f"  {name} torch.argsort(stable=True) of [{pop[5].shape[0]}, {pop[3].shape[0]}] "
              f"int32 keys: {argsort_ms!r} ms a call (CUDA events) beside population_pairs' "
              f"{t['population_pairs'][0]!r} ms")
    for f in ("ffd_scan_batched", "ffd_scan_cluster_batched", "ffd_scan_global_batched",
              "verdict_rows", "population_prologue"):
        if f not in errs:
            fail(f"phase 6 never compared {f}")
    return {k: dict(figures[k], launches=launches[k], err=errs[VERDICT_FUNCTION.get(k, k)])
            for k in VERDICT_KERNELS}



# ---------------------------------------------------------------------------
# Phase 7: the operator's provisioning loop
# ---------------------------------------------------------------------------


def operator_env(device: str):
    """The port's operator environment over config 2's catalog, its
    ``general`` and tainted ``dedicated`` pools and a default NodeClass,
    the Provisioner's solver on ``device``.  Launches go one at a time in
    claim order (the simulator's determinism knob), so a card run and a
    CPU run hand out the same instance ids."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.api import Settings, reset_name_sequences
    from karpenter_tpu_torch.cloud.fake.catalog import generate_catalog

    reset_name_sequences()
    settings = Settings(cluster_name="chip-smoke", enable_admission_fastpath=False,
                        enable_pipelined_reconcile=False)
    env = T.Environment(shapes=generate_catalog(**T.CONFIG2_CATALOG), settings=settings,
                        device=device)
    env.default_node_class()
    env.default_node_pool(name="general")
    env.default_node_pool(name="dedicated", taints=[T.DEDICATED_TAINT])
    env.operator.provisioner.launch_concurrency = 1
    return env


class GcTimer:
    """A ``gc.callbacks`` entry that sums the milliseconds of the garbage
    collector's passes."""

    def __init__(self):
        self.ms = 0.0
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t0) * 1e3


def tick_summary(tick: int, kind: str, tick_s: float, controller_s: dict,
                 phases: dict, kernel: str, section: dict, detail: dict,
                 launches: dict, gc_ms: float = 0.0) -> dict:
    """One operator tick as phase 7 prints it: the operator's own tick time
    (``karpenter_reconcile_tick_duration_seconds``) and each controller's
    in ms, the solve's kind ("" where the tick solved nothing), its phases
    in ms and the kernel it ran, the kernel launches the tick counted, the
    garbage collector's ms in the step, and the device observatory's tick
    section with its breakdown."""
    return {
        "tick": tick,
        "tick_ms": tick_s * 1e3,
        "gc_ms": gc_ms,
        "controllers_ms": {k: v * 1e3 for k, v in controller_s.items()},
        "solve": kind,
        "kernel": kernel if kind else "",
        "phases_ms": {k: v * 1e3 for k, v in sorted(phases.items())} if kind else {},
        "launches": {k: v for k, v in launches.items() if v},
        "device": {**section, **detail},
    }


def operator_tick(env, tick: int, launches=None, gc_timer=None) -> dict:
    """One ``env.step`` of fake clock, read back as its `tick_summary`.
    ``launches`` is the kernel wrappers' counter dict (None on the CPU),
    ``gc_timer`` a `GcTimer` (None: not timed)."""
    from karpenter_tpu_torch.obs.device import OBSERVATORY
    from karpenter_tpu_torch.operator import solve_kind, solver_counters

    sched = env.operator.provisioner.scheduler
    before = solver_counters(sched)
    counted = dict(launches) if launches is not None else {}
    gc0 = gc_timer.ms if gc_timer is not None else 0.0
    env.step(TICK_S)
    kind = solve_kind(before, solver_counters(sched))
    reg = env.registry
    controller_s = {}
    for name in CONTROLLERS:
        samples = reg.histogram("karpenter_controller_reconcile_time_seconds",
                                {"controller": name})
        controller_s[name] = samples[-1] if samples else 0.0
    tick_s = reg.histogram("karpenter_reconcile_tick_duration_seconds")[-1]
    return tick_summary(
        tick, kind, tick_s, controller_s, sched.last_phases, sched.last_kernel,
        OBSERVATORY.tick_section(), OBSERVATORY.tick_detail(),
        {k: v - counted[k] for k, v in launches.items()} if launches is not None else {},
        gc_timer.ms - gc0 if gc_timer is not None else 0.0,
    )


def churn_bound(env, rng, n: int) -> None:
    """Replace ``n`` bound pods (drawn from the bound pods in key order) by
    new pending pods of their shapes."""
    from karpenter_tpu_torch.api import Pod

    kube = env.kube
    bound = sorted(k for k, p in kube.pods.items() if p.node_name)
    for key in rng.sample(bound, n):
        old = kube.pods[key]
        kube.delete_pod(key)
        kube.put_pod(Pod(requests=old.requests, node_selector=dict(old.node_selector),
                         tolerations=list(old.tolerations)))


def drive_operator(device: str, n_pods: int = OPERATOR_PODS, rounds: int = CHURN_ROUNDS,
                   churn_pods: int = CHURN_PODS, launches=None, profile_last=None,
                   gc_timer=None):
    """Phase 7's drive on ``device``: config 2's first ``n_pods`` pods into
    the store, ticks until every pod is bound, then ``rounds`` churn rounds
    (an arrival tick, a solving tick, and up to two more while pods wait).
    ``profile_last(run_tick)`` wraps the last round's solving tick.
    Returns (env, tick summaries, what ``profile_last`` returned)."""
    import random

    from karpenter_tpu_torch import testing as T

    env = operator_env(device)
    for p in T.heterogeneous_pods(n_pods):
        env.kube.put_pod(p)
    ticks = []

    def run_tick():
        ticks.append(operator_tick(env, len(ticks) + 1, launches, gc_timer))

    for _ in range(MAX_BIND_TICKS):
        run_tick()
        if not env.kube.pending_pods():
            break
    if env.kube.pending_pods():
        fail(f"phase 7 ({device}): {len(env.kube.pending_pods())} of {n_pods} pods "
             f"unbound after {MAX_BIND_TICKS} ticks")
    rng = random.Random(CHURN_SEED)
    profiled = None
    for r in range(rounds):
        churn_bound(env, rng, churn_pods)
        run_tick()
        if profile_last is not None and r == rounds - 1:
            profiled = profile_last(run_tick)
        else:
            run_tick()
        for _ in range(2):
            if env.kube.pending_pods():
                run_tick()
        if env.kube.pending_pods():
            fail(f"phase 7 ({device}): churn round {r + 1} left "
                 f"{len(env.kube.pending_pods())} pods unbound")
    errors = env.registry.counters.get("karpenter_controller_reconcile_errors_total", {})
    if errors:
        fail(f"phase 7 ({device}): controller reconcile errors {dict(errors)}")
    return env, ticks, profiled


def tick_p50s(ticks) -> dict:
    """The p50 of the operator's tick ms by the kind of its solve ("none"
    where the tick solved nothing), with the tick count of each kind."""
    by_kind = {}
    for t in ticks:
        by_kind.setdefault(t["solve"] or "none", []).append(t["tick_ms"])
    return {k: {"p50_ms": statistics.median(v), "ticks": len(v)}
            for k, v in sorted(by_kind.items())}


def operator_phase(torch, card):
    """Phase 7 as the module docstring lists it.  Returns the launch counts
    of the card's drive."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F

    F.reset_launches()
    t0 = time.perf_counter()

    def profiled_tick(run_tick):
        torch.cuda.synchronize()
        return profile_solve(torch, lambda _: run_tick(), None)

    import gc

    gc_timer = GcTimer()
    gc.callbacks.append(gc_timer)
    try:
        env, ticks, profiled = drive_operator("cuda", launches=F.LAUNCHES,
                                              profile_last=profiled_tick, gc_timer=gc_timer)
    finally:
        gc.callbacks.remove(gc_timer)
    torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)
    card_s = time.perf_counter() - t0
    sched = env.operator.provisioner.scheduler
    for t in ticks:
        print("  tick " + json.dumps(t), flush=True)
    solves = [t for t in ticks if t["solve"]]
    print(f"  {len(ticks)} ticks, {len(solves)} solves "
          f"({', '.join(t['solve'] for t in solves)}) in {card_s!r} s; "
          f"{len(env.kube.node_claims)} NodeClaims, {len(env.kube.nodes)} nodes, "
          f"{len(env.kube.pods)} pods bound; launches over the drive {launches}", flush=True)
    for t in solves:
        if t["kernel"] != "cuda_ffd":
            fail(f"phase 7: tick {t['tick']} solved with {t['kernel']!r}, not on the card")
        got = t["launches"]
        if got.get("choose_config", 0) < 1 or sum(got.get(k, 0) for k in SCAN_KERNELS) < 1:
            fail(f"phase 7: tick {t['tick']}'s solve launched {got}")
    if launches["choose_config"] < len(solves) or launches["ffd_scan_global"]:
        fail(f"phase 7: launches {launches} over {len(solves)} solves")
    if sched.last_resident:
        picked = F.scan_kernel(*pack_shapes(sched._resident.states[-1].pack_args()))
        if not solves[-1]["launches"].get(picked):
            fail(f"phase 7: the last solve did not launch {picked}, the scan its shapes pick")
        print(f"  the last solve ran {picked}, the scan its resident state's shapes pick")
    print(f"  tick p50 by solve kind ({card}): {json.dumps(tick_p50s(ticks))}")
    print(f"  profiled churn solve tick (torch.profiler, {card}): "
          + (json.dumps(profiled) if profiled else "not measured: no device time seen"))
    print(f"  observatory totals: {json.dumps(observatory_totals())}", flush=True)
    t0 = time.perf_counter()
    cpu_env, cpu_ticks, _ = drive_operator("cpu")
    print(f"  the same drive on the CPU (plain version): {len(cpu_ticks)} ticks in "
          f"{time.perf_counter() - t0!r} s", flush=True)
    card_state, cpu_state = T.operator_state(env), T.operator_state(cpu_env)
    for key in card_state:
        if card_state[key] != cpu_state[key]:
            fail(f"phase 7: the card's {key} differ from the CPU operator's")
    if [t["solve"] for t in ticks] != [t["solve"] for t in cpu_ticks]:
        fail("phase 7: the card's solve kinds differ from the CPU operator's")
    print(f"  the card's NodeClaims, nodes, bindings, cloud calls, ledger "
          f"({sum(card_state['event_counts'].values())} events, the last "
          f"{len(card_state['events'])} compared one by one) and solver counters equal "
          f"the CPU operator's")
    return launches


def observatory_totals() -> dict:
    from karpenter_tpu_torch.obs.device import OBSERVATORY

    snap = OBSERVATORY.snapshot()
    return {k: snap[k] for k in ("dispatches", "compiles", "compile_seconds",
                                 "transfer_bytes", "resident")}


def main(argv) -> int:
    """The run as the module docstring lists it."""
    through = parse_through(argv)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    try:
        from karpenter_tpu_torch.ops import _build
        from karpenter_tpu_torch.ops import fused_packer as F
        from karpenter_tpu_torch.scheduling.solver import TorchScheduler
    except ImportError as exc:
        fail(f"karpenter_tpu_torch is not importable next to this script: {exc}")
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    phase_done(1, through)

    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.SOURCES)} source(s) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for name in _build.SOURCES:
        log = _build.BUILD_LOG.get(name, "").strip()
        if not log:
            fail(f"no -Xptxas -v summary for {name}.cu")
        for line in log.splitlines():
            print(f"  {name}: {line}")
    res = ptxas_resources(_build.BUILD_LOG["ffd_pack"])
    choice = [k for k in res if "choose_config_kernel" in k]
    if len(choice) != 2:  # kMulti false and true
        fail(f"ptxas reported {len(choice)} instances of choose_config_kernel, expected 2")
    for name in SPILL_CHECKED:
        syms = [k for k in res if f"{name}_kernel" in k]
        if not syms:
            fail(f"ptxas reported no {name}_kernel")
        for sym in sorted(syms):
            regs, st, ld = res[sym]
            print(f"  {name}_kernel {sym}: {regs} registers, spill stores {st} bytes, "
                  f"spill loads {ld} bytes")
            if st or ld:
                fail(f"{name}_kernel {sym} spills ({st} / {ld} bytes)")
    phase_done(2, through)

    specs = problems()
    probs = {name: compiled(spec) for name, spec in specs.items()}
    for name, prob in probs.items():
        G, C = prob.feas.shape
        print(f"[problem] {name}: pods={prob.total_pods()} classes={G} "
              f"configs={C} axes={len(prob.axes)} tracked={prob.n_track_slots}")

    print("[kernel vs plain] bit-equality on the card", flush=True)
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import packer as P

    padded = lambda prob, k=0: P.to_device(P.pad_problem(prob, k)[0], dev)
    wrap = lambda k, at=0: P.to_device(T.wrap_arrays(k, at=at), dev)
    # each problem at the main path's shapes: the resident tensors a cold
    # solve on the card seeds (config 2 and the flagship: 512 slots)
    kargs = {name: main_path_state(torch, spec).pack_args() for name, spec in specs.items()}
    for name, args in kargs.items():
        G, R = args[0].shape
        print(f"  {name}: main-path tensors Gp={G} Cp={args[5].shape[0]} "
              f"Kp={args[8].shape[0]} R={R}")
    glob = [("ffd_scan_global", F.ffd_scan_global, "ffd_scan_global")]

    def sizes(args):  # the cluster scan forced onto each other cluster size
        return [(f"ffd_scan_cluster ctas={n}",
                 lambda *a, n=n: F.ffd_scan_cluster(*a, ctas=n), "ffd_scan_cluster")
                for n in other_cluster_sizes(*pack_shapes(args))]

    straddle = wrap(4096, at=4096 // 2 - 2)
    # name -> (card tensors, the scan the shape rule must pick, more scans)
    cases = {
        "config2": (kargs["config2"], "ffd_scan", glob),
        "flagship": (kargs["flagship"], "ffd_scan", []),
        "config2_live": (kargs["config2_live"], "ffd_scan_cluster",
                         glob + sizes(kargs["config2_live"])),
        "config2 k_slots=4096": (padded(probs["config2"], 4096), "ffd_scan_cluster", []),
        "config2 k_slots=8192": (padded(probs["config2"], 8192), "ffd_scan_cluster", []),
        "config2 k_slots=16384": (padded(probs["config2"], 16384), "ffd_scan_cluster", []),
        "wrap k_slots=256": (wrap(256), "ffd_scan", []),
        "wrap k_slots=4096": (wrap(4096), "ffd_scan_cluster", glob),
        "wrap k_slots=4096 straddling slot 2048": (straddle, "ffd_scan_cluster", sizes(straddle)),
        "wrap k_slots=16384 straddling slot 8192": (
            wrap(16384, at=16384 // 2 - 2), "ffd_scan_cluster", []),
    }
    errs, kouts = {}, {}
    for name, (args, picked, extra) in cases.items():
        layout = F.cluster_layout(*pack_shapes(args)) if picked == "ffd_scan_cluster" else None
        print(f" {name}" + (f" (cluster of {layout[0]} CTAs, {layout[1]} slots a thread, "
                            f"{layout[2]} bytes of shared memory each)" if layout else ""))
        e, kouts[name] = compare_kernels(torch, args, picked, extra)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
    # the choice on its own cases
    shifted = list(kargs["config2"])
    feas = shifted[4]
    buf = torch.zeros(feas.numel() + 1, dtype=torch.bool, device=dev)
    buf[1:] = feas.reshape(-1)
    shifted[4] = buf[1:].view(feas.shape)  # one byte off: read a config at a time
    choose_cases = {
        **kargs,
        "wrap k_slots=256": wrap(256),
        "ties": P.to_device(T.tie_arrays(), dev),
        "ties configs=16384": P.to_device(T.tie_arrays(16384), dev),
        "configs=6": P.to_device(T.first_configs(T.wrap_arrays(256), 6), dev),
        "config2 feas one byte off": tuple(shifted),
    }
    for name, args in choose_cases.items():
        errs["choose_config"] = max(errs.get("choose_config", 0.0),
                                    compare_choose(torch, name, args))
    for k in ("choose_config", *SCAN_KERNELS):
        if k not in errs:
            fail(f"phase 3 never ran {k}")
    phase_done(3, through)

    print(f"[kernel times] torch.profiler device time and CUDA events, {card}", flush=True)
    times = {name: time_kernels(torch, args, scan_turns=name in ("config2", "config2_live"))
             for name, args in kargs.items()}
    for name, t in times.items():
        for k, (dev_ms, ev_ms, plain, readings) in t.items():
            print(f"  {name} {k}: kernel {dev_ms!r} ms device (profiler, mean of "
                  f"{readings!r}), {ev_ms!r} ms per call (CUDA events), "
                  f"plain {plain!r} ms (CUDA events)")
    c2t, livet = times["config2"], times["config2_live"]
    print(f"  config2 ffd_scan_global / ffd_scan device time, in turns at "
          f"{kargs['config2'][8].shape[0]} slots: "
          f"{c2t['ffd_scan_global'][0] / c2t['ffd_scan'][0]!r}")
    print(f"  config2_live ffd_scan_global / ffd_scan_cluster device time, in turns at "
          f"{kargs['config2_live'][8].shape[0]} slots: "
          f"{livet['ffd_scan_global'][0] / livet['ffd_scan_cluster'][0]!r}")
    bounds = {}
    for k in ("choose_config", *SCAN_KERNELS):
        name = ROW_PROBLEM[k]
        take, _, node_cfg, _, _ = kouts[name]
        b = kernel_bounds(kargs[name], take, node_cfg)
        bounds[k] = b[k if k == "choose_config" else "ffd_scan"]  # one function, two scans
        print(f"  {name} {k} bound: {bounds[k]}")
    steps = {name: (kargs[name][0].shape[0], kargs[name][8].shape[0])
             for name in ("config2", "config2_live")}
    live_shapes = pack_shapes(kargs["config2_live"])
    cluster_threads = {n: F.scan_threads(-(-live_shapes[0] // n)) for n in F.CLUSTER_SIZES
                       if F.cluster_layout(*live_shapes, n)}
    barrier_us, cluster_us, l2_us = probe_latencies(
        torch, sorted({F.scan_threads(K) for _, K in steps.values()}),
        sorted(cluster_threads.items()))
    print(f"  latency probes ({card}): barrier round trip {barrier_us!r} us "
          f"(by threads), cluster exchange + barrier round trip {cluster_us!r} us "
          f"(by cluster size, threads), dependent L2 load {l2_us!r} us")

    def floor_ms(kernel, name, ctas=None):
        """``ctas``: a cluster size the rule does not pick (phase 4's label)."""
        G, K = steps[name]
        barriers, loads = scan_step_model(kernel, K)
        label = f"{kernel} ctas={ctas}" if ctas else None
        if kernel == "ffd_scan_cluster":
            n = ctas or F.cluster_layout(*live_shapes)[0]
            b_us, where = cluster_us[(n, cluster_threads[n])], (
                f"cluster barriers of {n} CTAs of {cluster_threads[n]} threads")
        else:
            b_us, where = barrier_us[F.scan_threads(K)], (
                f"barriers at {F.scan_threads(K)} threads")
        ms = scan_latency_floor_ms(kernel, G, K, b_us, l2_us)
        print(f"  {name} {label or kernel} latency floor: {G} steps x ({barriers} {where} + "
              f"{loads} L2 loads) = {ms!r} ms; measured / floor "
              f"{times[name][label or kernel][0] / ms!r}")
        return ms

    floors = {"choose_config": None}
    floors.update({k: floor_ms(k, ROW_PROBLEM[k]) for k in SCAN_KERNELS})
    for n in other_cluster_sizes(*live_shapes):
        floor_ms("ffd_scan_cluster", "config2_live", ctas=n)
    pr1_floor = floor_ms("ffd_scan_global", "config2")
    print(f"  config2 ffd_scan / the global kernel's floor model at config2: "
          f"{c2t['ffd_scan'][0] / pr1_floor!r}")
    phase_done(4, through)

    print(f"[slice] TorchScheduler.solve on the card, {card}", flush=True)
    import random

    solves = len(SOLVE_KINDS) * (WARMUP_SOLVES + TIMED_SOLVES)
    rng = random.Random(0)
    F.reset_launches()
    solved, per_problem = {}, {}
    for name, spec in specs.items():
        print(f"  {name}:", flush=True)
        before = dict(F.LAUNCHES)
        solved[name] = drive_solves(torch, name, spec, rng)
        per_problem[name] = {k: F.LAUNCHES[k] - before[k] for k in KERNELS}
    launches = dict(F.LAUNCHES)
    print(f"  launches over {len(specs) * solves} solves: {launches}, "
          f"per problem {per_problem}")
    for name, got in per_problem.items():
        scan = "ffd_scan_cluster" if name == "config2_live" else "ffd_scan"
        for k in ("choose_config", scan):
            if got[k] != solves:
                fail(f"{name}: kernel {k} launched {got[k]} times over {solves} solves")
        if got["ffd_scan_global"]:
            fail(f"{name}: ffd_scan_global launched {got['ffd_scan_global']} times")
    for name, (sched, pods, ts, phases) in solved.items():
        for sk in SOLVE_KINDS:
            print(f"  {name} {sk}: p50_ms={statistics.median(ts[sk])!r} "
                  f"min_ms={min(ts[sk])!r} max_ms={max(ts[sk])!r} ({card})")
            print(f"    last_phases_ms={json.dumps({k: v * 1e3 for k, v in sorted(phases[sk].items())})}")
        for sk in SOLVE_KINDS:
            # each profiled solve follows an unprofiled one of its kind
            solve = (lambda q, s=sched: cold_solve(s, q)) if sk == "cold" else sched.solve
            warm = p = pods
            if sk == "delta":
                warm = churn(rng, pods, specs[name][3])
                p = churn(rng, warm, specs[name][3])
            solve(warm)
            torch.cuda.synchronize()
            prof = profile_solve(torch, solve, p)
            print(f"    profiled {sk} solve (torch.profiler, {card}, "
                  f"resident={sched.last_resident}): "
                  + (json.dumps(prof) if prof else "not measured: no device time seen"))

    phase_done(5, through)

    print(f"[verdicts] the consolidation verdicts on the card, {card}", flush=True)
    verdicts = verdict_phase(torch, card)
    phase_done(6, through)

    print(f"[operator] the provisioning loop on the card, {card}", flush=True)
    op_launches = operator_phase(torch, card)

    kernels = []
    for k in ("choose_config", *SCAN_KERNELS):
        dev_ms, _, plain, _ = times[ROW_PROBLEM[k]][k]
        kernels.append({
            "name": k,
            "problem": ROW_PROBLEM[k],
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": launches[k],
            "max_abs_err": errs[k],
            "ms": dev_ms,
            "plain_ms": plain,
            "bound_ms": bounds[k]["bound_ms"],
            "bound_by": bounds[k]["bound_by"],
            "library_ms": None,
            "latency_floor_ms": floors[k],
            "operator_launches": op_launches[k],
        })
    for k in VERDICT_KERNELS:
        v = verdicts[k]
        kernels.append({
            "name": k,
            "problem": ROW_PROBLEM[k],
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": VERDICT_REPLACES[k],
            "launches": v["launches"],
            "max_abs_err": v["err"],
            "ms": v["ms"],
            "plain_ms": v["plain_ms"],
            "bound_ms": v["bound"]["bound_ms"],
            "bound_by": v["bound"]["bound_by"],
            "library_ms": None,
            "latency_floor_ms": v["floor"],
            "operator_launches": op_launches[k],
            **({"argsort_ms": v["argsort_ms"]} if v["argsort_ms"] is not None else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
