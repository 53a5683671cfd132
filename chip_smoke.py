#!/usr/bin/env python3
"""Drive karpenter_tpu_torch on one NVIDIA card and check what comes out.

    python3 chip_smoke.py               # every phase
    python3 chip_smoke.py --through N   # phases 1-N (N = 1-8), then exit 3

Phases (each failure exits non-zero before the last line is printed):

1. Device: requires ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles every CUDA source of the package with ``nvcc`` (all at
   once) and prints the ``-Xptxas -v`` summary of each, then the registers
   and spills of each instance of ``choose_config_kernel``, of the
   frontier-window scan and of the verdict and prologue kernels (fails on
   a spill).
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
   the drive and read just after: the batched scans of each problem's
   shapes (`fused_packer.batch_launches`: the frontier-window scan alone at
   ``sweep``, whose Kp 1024 fits its window, the cluster scan alone at
   ``live``, whose 2,000 live slots pass it), each of `verdict_rows`' three
   launches (``verdict_summary``, ``verdict_configs``, ``verdict_write``)
   and ``population_pairs`` (the prologue) must have launched, no other
   batched scan; each batched launch group's shapes, W, plan, the elements
   the window finished and those the picked scan took (its ``done`` mask,
   read after a synchronize, must be the elements whose frontier stays
   within W), and the largest element frontier.  The
   decoded verdicts (and the plan's proposals and pick) must equal the
   same calls through ``device="cpu"``.  Then on the same card tensors
   each kernel against its plain version, bit for bit: the batched scan
   (full outputs, as the wrapper launches it and the picked scan on every
   element; at ``live`` also through the global scan),
   ``population_prologue``'s three outputs and the [B, 6] rows; then the
   tie and edge cases (``testing.verdict_tie_arrays``: equal masked prices
   across warps and config tiles, elements in two groups, an element with
   every config masked, one with no new slot, one with many; Gp 8 and 40;
   Cp 6, 1000 and 8192 at the live problem's Kp 4096 and B 512; next0 0
   and K), both objectives, through ``removal_verdicts`` and through
   `verdict_rows` at next0, 0 and K; the prologue with U and Gp past its
   block (``testing.population_arrays``); the frontier-window cases
   (``testing.frontier_arrays``: frontiers inside, at and past W, next0
   past W, Kp within W, -0.0 usages in the tail and the window, a request
   of +inf, caps of 2^30), each with the launches its plan makes, its
   ``done`` mask, its outputs and its verdict rows, together all three
   plans and elements the picked scan took after the window.  Each
   kernel's device time
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
   with its ``general`` and ``dedicated`` pools and a default NodeClass
   (their ``consolidate_after`` outlasts the drive: the disruption
   controller runs every tick and takes no action).
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
8. Single-pod arrivals: the same operator with the admission fast path and
   the singleton bypass on; the 10,000 pods bound, a seeded 30 % of them
   deleted (headroom on most nodes), then one arrival a tick: 200 single
   pods of config 2's shapes, 10 bursts of 2-8 pods of one shape (each
   with a quiet tick after it) and 5 pods of 100+ vCPU, interleaved so
   that the first ``ARRIVAL_CUT`` entries hold every kind.  Fails on a
   fast-path mismatch, on fewer than half of the singles nominated by the
   fast path, on ``admit_kernel`` launches unequal to the scored attempts;
   the CPU drive (in a spawned process, `CpuTwins`, beside the card's
   drives) and the card drive with the fast path off run the first
   ``ARRIVAL_CUT`` entries only, must show every outcome and fallback
   reason of the card's full drive, and must equal the card's drive at
   that tick (`testing.operator_state`; the placements).  Then
   ``admit_kernel`` bit for bit against its plain version (every class of
   the resident state, the live cluster, the wrap cases and each of
   ``testing.admit_edge_arrays``' cases), its times and bound at the
   resident state and the live cluster, and its latency floor at both: an
   empty one-block launch at its thread count (``probe_barrier_kernel``
   with no iteration, timed here) plus its 2 block barriers and its
   dependent L2 load rounds (2, and one for each further pair of slot
   rounds that holds a live slot: `admit_loads`) at the round trips
   ``csrc/latency_probe.cu`` measures here.
9. Consolidation through the operator: `testing.consolidating_cluster`
   on the card (config 2's 10,000 pods bound, a seeded half deleted, the
   pools' ``consolidate_after`` lowered to 6 s; the default Settings, so
   the pipelined schedule brackets each tick with the disruption
   controller's speculative stages), then ticks until disruption takes no
   action for 3 ticks in a row with no pod pending (120 at most).  The
   launch counters are set to 0 just before the drive and read just
   after: ``choose_config``, the frontier-window scan, ``verdict_summary``,
   ``verdict_configs``, ``verdict_write`` and ``population_pairs`` must
   have launched, ``ffd_scan_global_batched`` not; at least one action,
   every pod bound, no reconcile error, no verdict mismatch; the ledger's
   ``NodeDisrupted`` / ``VerdictFallback`` events in order and the final
   `testing.operator_state` must equal the same drive on the CPU (run in
   the spawned process too).  Prints
   nodes and summed price before and after, actions by mechanism and
   reason, evaluations by path, the disruption reconcile's ms, the tick
   ms of ticks that consolidate and of those that do not, the
   speculation's outcomes, and profiled ticks (the device busy share of
   the first one that consolidates), and each batched launch group as
   phase 6 prints them.  Then phase 9's base (`consolidation_base`: the
   removal base the drive built at its largest Kp, with a seeded first
   population round as its batch): the wrapper's launches and the picked
   scan on every element held to the plain version bit for bit, the
   batched scan's bound and latency floors at these shapes, and the two
   timed in turns (the parent's batched scan; the window scan and the
   launch after it; twice; the parent's), which gives the window scan's
   row of the kernels line.
Then it prints the kernels JSON line (every kernel, the old and the new;
``operator_launches`` is phase 7's count, ``consolidation_launches``
phase 9's), the card line, and last ``{"ok": true, "device": {...}}``.
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
                   "ffd_scan_global_batched", "ffd_scan_window_batched", *VERDICT_ROWS,
                   "population_pairs")
# the wrapper (the function held to its plain version) of each verdict launch
VERDICT_FUNCTION = {**{k: "verdict_rows" for k in VERDICT_ROWS},
                    "population_pairs": "population_prologue"}
KERNELS = ("choose_config", *SCAN_KERNELS, *VERDICT_KERNELS, "admit_kernel")
LIVE_NODES = 2000  # phase 5's live cluster: 2,000 + 256 slots -> 4096
# the problem each kernel's row of the kernels line is measured at: the one
# whose solves launch it (the global scan: where it ran before the cluster
# scan took that shape)
ROW_PROBLEM = {"choose_config": "config2", "ffd_scan": "config2",
               "ffd_scan_global": "config2_live", "ffd_scan_cluster": "config2_live",
               "ffd_scan_batched": "sweep", "ffd_scan_cluster_batched": "live",
               "ffd_scan_global_batched": "live",
               "ffd_scan_window_batched": "consolidation",
               **{k: "live" for k in VERDICT_FUNCTION},
               "admit_kernel": "arrivals"}
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
    "ffd_scan_window_batched": "karpenter_tpu/ops/packer.py:615",
    **{k: "karpenter_tpu/ops/packer.py:525" for k in VERDICT_ROWS},
    "population_pairs": "karpenter_tpu/ops/packer.py:686",
}
SWEEP_PODS = 560
LIVE_UNIVERSE = 64
POPULATION = {"sweep": 320, "live": 512}
SEARCH_ROUNDS, SEARCH_SEED, VERDICT_SEED = 2, 7, 8
TIMED_VERDICTS = 5
# the scan each verdict problem's shapes pick (its batched form runs after
# the frontier-window scan where `fused_packer.batch_launches` says so: at
# ``sweep`` the window holds every slot, at ``live`` next0 is past it)
VERDICT_SCAN = {"sweep": "ffd_scan", "live": "ffd_scan_cluster"}
L2_PROBE_BYTES = 8 << 20  # pointer-chase buffer: past L1, well inside L2
# the kernels whose registers phase 2 prints and whose spills fail the run
SPILL_CHECKED = ("choose_config", "ffd_scan_window", *VERDICT_ROWS, "population_pairs",
                 "admit")
# phase 7: the operator over config 2's catalog and all of its pods, ticks
# of fake clock, the ticks allowed until every pod is bound, the churn
OPERATOR_PODS = 10_000
TICK_S = 2.0
MAX_BIND_TICKS = 12
CHURN_ROUNDS, CHURN_PODS, CHURN_SEED = 5, 100, 3
# the operator's controllers, in its order (interruption only runs with a
# queue, which phases 7-9 do not set)
CONTROLLERS = ("nodeclass", "provisioner", "lifecycle", "disruption", "termination",
               "link", "garbagecollection", "tagging", "metrics_state", "consistency")
# phases 7 and 8 drive provisioning: their pools' consolidate_after outlasts
# the drive, so the disruption controller runs each tick and takes no action
HOLD_CONSOLIDATION_S = 1e9
# phase 8: on the bound cluster of phase 7's first ticks with a seeded 30 %
# of its pods deleted (headroom on most nodes), one arrival a tick: single
# pods of config 2's shapes, bursts of 2-8 pods of one class (each followed
# by a quiet tick), pods larger than any live node's headroom, interleaved
# so that the first ARRIVAL_CUT entries hold every kind
ARRIVALS, BURSTS, OVERSIZED = 200, 10, 5
BURST_SIZES = (2, 8)
ARRIVAL_SEED = 11
HEADROOM_SEED, HEADROOM_SHARE = 17, 0.3
BURST_EVERY, OVERSIZED_EVERY = 20, 40  # a burst after every 20th single, ...
# plan entries the CPU and fast-path-off drives run: past the instance-type
# cache's 300 s TTL (150 ticks), whose roll is one of the fast path's
# fallback reasons
ARRIVAL_CUT = 160
OVERSIZED_CPU = 100.0  # vCPU: more than half the largest type, so one a node
ADMIT_REPLACES = "karpenter_tpu/ops/packer.py:197"  # admit_kernel, jitted XLA
ADMIT_ITERS = 200  # launches a timing reading averages
# admit_kernel's chain (csrc/ffd_pack.cu): 2 block barriers (the warps'
# slot round totals, whose shared words carry the open bit too; the placed
# total) and 2 dependent load rounds: the class row, the slots' configs and
# the configs' bytes; then the first group of ADMIT_SLOT_GROUP slot rounds'
# feasibility bytes and alloc and used0 axes with the first group of
# candidate configs' alloc axes.  Each further group of slot rounds that
# holds a live slot is a round more; a warp none of whose first configs
# fits tests the next group in a further round (data-dependent: the floor
# counts none).
ADMIT_BARRIERS, ADMIT_FIXED_LOADS, ADMIT_SLOT_GROUP = 2, 2, 2
# phase 9: consolidation through the operator (testing.consolidating_cluster:
# phase 7's bound cluster, a seeded half of its pods deleted), ticks until
# disruption takes no action for CONSOLIDATION_QUIET ticks in a row with no
# pod pending, at most CONSOLIDATION_TICKS; profiled ticks at most
CONSOLIDATION_QUIET, CONSOLIDATION_TICKS, PROFILED_TICKS = 3, 120, 6
# phase 9's base: the removal batch its kernels are held and timed on (the
# first round of a SearchPlan pass over the base's universe, as the
# disruption controller's population search sizes it), and the timed calls
# of each side of the in-turns reading
BASE_POPULATION, BASE_SEED, BASE_ITERS = 128, 19, 5
# what phase 9's drive must launch through the operator
CONSOLIDATION_KERNELS = ("choose_config", *VERDICT_ROWS, "population_pairs")
# the CPU drives of phases 8 and 9 run in a process of their own, beside
# the card's drives, on this many of the host's threads
CPU_TWIN_THREADS = 3


LAST_PHASE = 9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def parse_through(argv) -> int:
    """The last phase to run: ``--through N`` (N = 1-8) stops after phase
    N; no argument runs them all.  Anything else exits 2."""
    if not argv:
        return LAST_PHASE
    if len(argv) == 2 and argv[0] == "--through" and argv[1] in tuple("12345678"):
        return int(argv[1])
    print("usage: python3 chip_smoke.py [--through N]  (N = 1-8: stop after phase N)",
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


def window_report(torch, label, records, each: bool = False) -> dict:
    """The batched launch groups `fused_packer.WINDOW_RECORDS` took (read
    after a synchronize, off the main path): for each group its B, Gp, Kp,
    Cp, next0, W and plan, how many elements the frontier-window scan
    finished and how many the picked scan took after it, and the largest
    element frontier (`testing.element_frontiers` of its node_cfg).  Fails
    where the window's `done` mask is not the elements whose frontier stays
    within W (the main path's usages are sums of requests: clean and
    finite, so no tail moves).  ``each``: a line a group, else a line per
    distinct shape.  Returns the totals."""
    from karpenter_tpu_torch import testing as T

    torch.cuda.synchronize()
    lines, tot = {}, {"groups": 0, "elements": 0, "window": 0, "second": 0, "max_frontier": 0}
    for r in records:
        front = T.element_frontiers(r["node_cfg"].cpu().numpy(), r["next0"])
        if r["done"] is None:
            finished = 0
        else:
            done = r["done"].cpu().numpy()
            if (done != (front <= r["W"])).any():
                fail(f"{label}: the window's done mask {done.tolist()} is not the elements whose "
                     f"frontier {front.tolist()} stays within W {r['W']}")
            finished = int(done.sum())
        second = r["B"] - finished if r["plan"] != "window" else 0
        key = tuple(r[k] for k in ("B", "Gp", "Kp", "Cp", "next0", "W", "plan"))
        line = lines.setdefault(key if not each else (len(lines), *key), [0, 0, 0, 0])
        line[0] += 1
        line[1] += finished
        line[2] += second
        line[3] = max(line[3], int(front.max()))
        for k, v in (("groups", 1), ("elements", r["B"]), ("window", finished),
                     ("second", second)):
            tot[k] += v
        tot["max_frontier"] = max(tot["max_frontier"], int(front.max()))
    for key, (n, fin, sec, mf) in lines.items():
        B, Gp, Kp, Cp, next0, W, plan = key[-7:]
        print(f"  {label} batched launch{'es' if n > 1 else ''}: {n} x B={B} Gp={Gp} Kp={Kp} "
              f"Cp={Cp} next0={next0} W={W} plan={plan}: the window finished {fin}, the picked "
              f"scan took {sec}; largest element frontier {mf}")
    print(f"  {label} batched totals: {json.dumps(tot)}")
    return tot


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
    plan = F.batch_launches(next0, *pack_shapes(base.args))
    pop_outs = None
    for label, (cnt_b, rm_b, perm_b) in (("removal batch", batch), ("population", got_pop)):
        scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0,
                     sig0, cnt_b, rm_b, perm_b)
        outs, moved = launches_of(torch, lambda: F.ffd_scan_batch(*scan_args))
        if moved != dict.fromkeys(plan, 1):
            fail(f"{name} {label}: the batched scan launched {moved}, expected {plan}")
        want = P.ffd_scan_batch_reference(*scan_args)
        # the plan's launches, and the picked scan on every element
        scans = [(k, outs) for k in plan]
        scans.append((f"{picked}_batched", forced_scan(F, scan_args)()))
        if name == "live":
            scans.append(("ffd_scan_global_batched", F._launch_global(
                (req, cnt_b[0], *scan_args[1:13]), shapes,
                (perm_b.shape[0], perm_b, cnt_b, rm_b))))
        torch.cuda.synchronize()
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
              f"Kp={used0.shape[0]} Cp={alloc.shape[0]} R={req.shape[1]} launches {plan}: "
              + " ".join(f"{k} max_abs_err={v!r}" for k, v in sorted(errs.items())))
        if label == "population":
            pop_outs = (scan_args, outs, tail)
    if any(v != 0 for v in errs.values()):
        fail(f"{name} {objective}: a verdict kernel disagrees with its plain version: {errs}")
    return errs, pop, pop_outs


def launches_of(torch, fn):
    """``fn()``'s result (after a synchronize) and the launches it made."""
    from karpenter_tpu_torch.ops import fused_packer as F

    before = dict(F.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in F.LAUNCHES.items() if n != before[k]}


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


def batch_shapes(scan_args):
    """``(K, R, S, C)`` of `ffd_scan_batch`'s arguments, as `pack_shapes`."""
    return (scan_args[8].shape[0], scan_args[0].shape[1], scan_args[12].shape[0],
            scan_args[4].shape[0])


def forced_scan(F, scan_args):
    """A call of the scan `scan_kernel` picks at the shapes, with the batch
    axis, on every element of ``scan_args`` (no window scan before it)."""
    req, cnt_b, rm_b, perm_b = scan_args[0], *scan_args[13:]
    K, R, S, C = batch_shapes(scan_args)
    return lambda: F._launch_picked((req, cnt_b[0], *scan_args[1:13]), (req.shape[0], C, K, R, S),
                                    (perm_b.shape[0], perm_b, cnt_b, rm_b))


def time_verdict_kernels(torch, name, pop, pop_outs):
    """Device ms a launch (torch.profiler) of the batched scan the shapes
    pick (on every element: `forced_scan`) and, where the wrapper launches
    it, of the frontier-window scan (through `ffd_scan_batch`), each launch
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
    scan_plain = cuda_ms(torch, lambda: P.ffd_scan_batch_reference(*scan_args), iters=2, warmup=1)
    out = {
        f"{picked}_batched": (
            profiled_ms(torch, forced_scan(F, scan_args), picked, iters=20), scan_plain),
        **{k: (rows_ms[k], rows_plain) for k in VERDICT_ROWS},
        "population_pairs": (
            profiled_ms(torch, lambda: F.population_prologue(*pop), "population_pairs",
                        iters=50),
            cuda_ms(torch, lambda: P.population_prologue_reference(*pop), iters=5, warmup=1)),
    }
    if "ffd_scan_window_batched" in F.batch_launches(scan_args[11], *batch_shapes(scan_args)):
        out["ffd_scan_window_batched"] = (profiled_ms(
            torch, lambda: F.ffd_scan_batch(*scan_args), "ffd_scan_window", iters=20), scan_plain)
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


def batched_floor_ms(torch, name, base, B, barrier_us, l2_us, kernel=None) -> float:
    """A batched scan's latency floor: class steps x (its barrier + 2 /
    SCAN_TILE dependent L2 loads) x ceil(B / elements the card runs at
    once).  ``kernel``: the scan the base's shapes pick (``None``) or
    ``"ffd_scan_window"``, whose step is the resident scan's (one block
    barrier, the same tiles of class rows)."""
    from karpenter_tpu_torch.ops import fused_packer as F

    K, R, S, C = pack_shapes(base.args)
    G = base.args[0].shape[0]
    kernel = kernel or F.scan_kernel(K, R, S, C)
    at_once = F.scan_concurrency(K, R, S, C, kernel)
    waves = -(-B // at_once)
    _, loads = scan_step_model("ffd_scan" if kernel == "ffd_scan_window" else kernel, K)
    ms = G * (barrier_us + loads * l2_us) * waves / 1e3
    print(f"  {name} {kernel}_batched latency floor: {G} steps x ({barrier_us!r} us "
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
    removal verdicts through the card (the choice, the batched scans
    `fused_packer.batch_launches` names, the three launches of
    `verdict_rows`, each once) and
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

    for name, shape in T.VERDICT_TIE_CASES.items():
        a = P.to_device(T.verdict_tie_arrays(*shape), dev)
        (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
         pool_id, zone_id, ct_id, compactable, cnt_b, rm_b, perm_b) = a
        K, R = used0.shape
        scans = F.batch_launches(next0, K, R, sig0.shape[0], alloc.shape[0])
        scan = "+".join(scans)
        tail = (perm_b, feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable)
        for objective in OBJECTIVES:
            got, moved = launches_of(torch, lambda: F.removal_verdicts(*a, objective=objective))
            if moved != {"choose_config": 1, **dict.fromkeys(scans, 1),
                         **{k: 1 for k in VERDICT_ROWS}}:
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
            smem = F.verdict_rows_in_smem(torch.cuda.current_device(), req.shape[0], R)
            print(f"  {name} {objective}: B={perm_b.shape[0]} Gp={req.shape[0]} Kp={K} "
                  f"Cp={alloc.shape[0]} R={R} next0={next0} ({scan}; config pass rows in "
                  f"{'shared' if smem else 'device'} memory): verdict_rows max_abs_err={e!r} "
                  f"(also at next0 0 and K{', groups ' + repr(groups) if groups else ''}); rows "
                  f"{int(torch.isinf(got[:, 3]).sum())} +inf, "
                  f"c_min {sorted(set(got[:, 2].int().tolist()))[:6]}...")
            if e != 0:
                fail(f"{name} {objective}: verdict_rows disagrees with its plain version")
            errs["verdict_rows"] = max(errs["verdict_rows"], e)
    for U, G, K, Pm in T.PROLOGUE_CASES:
        a = P.to_device(T.population_arrays(U, G, K, Pm), dev)
        got, moved = launches_of(torch, lambda: F.population_prologue(*a))
        if moved != {"population_pairs": 1}:
            fail(f"population_prologue at U {U} Gp {G} launched {moved}")
        e = max_abs_err(torch, got, P.population_prologue_reference(*a))
        errs["population_prologue"] = max(errs["population_prologue"], e)
        print(f"  population_prologue U={U} Gp={G} K={K} P={Pm}: max_abs_err={e!r}")
        if e != 0:
            fail(f"population_prologue disagrees with its plain version at U {U} Gp {G}")
    return errs


def compare_batch_limit(torch):
    """Phase 6's batch past one launch: `testing.verdict_tie_arrays` at Gp 8,
    Kp 64 and B = `fused_packer.MAX_BATCH` + 101 elements.  The batched scan
    (at Kp 64 the frontier-window scan alone) must launch twice, each launch
    writing its slice, and equal its plain version bit for bit, as must
    `verdict_rows` on its outputs.  Returns the largest error per
    function."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    B = F.MAX_BATCH + 101
    a = P.to_device(T.verdict_tie_arrays(8, 300, 64, B, 4), torch.device("cuda"))
    (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
     pool_id, zone_id, ct_id, compactable, cnt_b, rm_b, perm_b) = a
    chosen = F.choose_config(req, maxper, feas, alloc, price, openable)
    scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
                 cnt_b, rm_b, perm_b)
    outs, moved = launches_of(torch, lambda: F.ffd_scan_batch(*scan_args))
    plan = F.batch_launches(next0, *batch_shapes(scan_args))
    if moved != dict.fromkeys(plan, 2):
        fail(f"the batched scan at B {B} launched {moved}, not {plan} twice")
    e_scan = max_abs_err(torch, outs, P.ffd_scan_batch_reference(*scan_args))
    tail = (perm_b, feas, alloc, price, openable, pool_id, zone_id, ct_id, compactable, next0)
    e_rows = max_abs_err(torch, [F.verdict_rows(*outs, *tail)],
                         [P.verdict_rows_reference(*outs, *tail)])
    print(f"  batch past one launch: B={B} Gp={req.shape[0]} Kp={used0.shape[0]} "
          f"(take {outs[0].numel() * 4} bytes), launches {moved}: "
          f"scan max_abs_err={e_scan!r}, verdict_rows max_abs_err={e_rows!r}")
    if e_scan != 0 or e_rows != 0:
        fail(f"the batched scan or verdict_rows at B {B} disagrees with its plain version")
    return {**dict.fromkeys(plan, e_scan), "verdict_rows": e_rows}


def compare_frontier_cases(torch):
    """Phase 6's frontier-window cases (`testing.frontier_arrays`), both
    objectives: `ffd_scan_batch` must make the launches `window_plan` says
    (the window alone, both, or the picked scan alone), its window's `done`
    mask must be `testing.window_finishes` (the elements whose frontier
    stays within W, where the tail does not move), and every output must
    equal the plain version bit for bit, as must the removal verdicts'
    rows.  The cases together must show all three plans and elements the
    picked scan took after they left the window.  Returns the largest error
    per function."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    dev = torch.device("cuda")
    errs = {"ffd_scan_window_batched": 0.0, "verdict_rows": 0.0}
    plans, left = set(), 0
    for case, (_, _, _, what) in T.FRONTIER_CASES.items():
        a = P.to_device(T.frontier_arrays(case), dev)
        (req, maxper, slot, feas, alloc, price, openable, used0, cfg0, npods0, next0, sig0,
         *_, cnt_b, rm_b, perm_b) = a
        K, R = used0.shape
        W = F.window_layout(K, R, sig0.shape[0], alloc.shape[0])[0]
        for objective in OBJECTIVES:
            chosen = F.choose_config(req, maxper, feas, alloc, price, openable, objective)
            scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0,
                         sig0, cnt_b, rm_b, perm_b)
            F.WINDOW_RECORDS = []
            try:
                outs, moved = launches_of(torch, lambda: F.ffd_scan_batch(*scan_args))
                (rec,) = F.WINDOW_RECORDS
            finally:
                F.WINDOW_RECORDS = None
            plan = F.batch_launches(next0, *batch_shapes(scan_args))
            if moved != dict.fromkeys(plan, 1):
                fail(f"frontier case {case}: the batched scan launched {moved}, expected {plan}")
            want = P.ffd_scan_batch_reference(*scan_args)
            e = max_abs_err(torch, outs, want)
            finishes = T.window_finishes(used0.cpu().numpy(), req.cpu().numpy(),
                                         want[2].cpu().numpy(), next0, W)
            done = rec["done"].cpu().numpy() if rec["done"] is not None else None
            if done is not None and (done != finishes).any():
                fail(f"frontier case {case}: the window's done mask {done.tolist()}, "
                     f"expected {finishes.astype(int).tolist()}")
            rows = F.removal_verdicts(*a, objective=objective)
            e_rows = max_abs_err(torch, [rows], [P.removal_verdicts_reference(
                *a, objective=objective)])
            front = T.element_frontiers(want[2].cpu().numpy(), next0)
            finished = 0 if done is None else int(done.sum())
            second = 0 if rec["plan"] == "window" else perm_b.shape[0] - finished
            print(f"  frontier case {case} ({what}) {objective}: B={perm_b.shape[0]} "
                  f"Gp={req.shape[0]} Kp={K} Cp={alloc.shape[0]} next0={next0} W={W} "
                  f"plan={rec['plan']} {plan}: the window finished {finished}, the picked scan "
                  f"took {second}; frontiers {front.min()}-{front.max()}; scan "
                  f"max_abs_err={e!r}, verdict rows max_abs_err={e_rows!r}")
            if e != 0 or e_rows != 0:
                fail(f"frontier case {case} {objective}: the batched scan or the verdict rows "
                     f"disagree with the plain version")
            plans.add(rec["plan"])
            if rec["plan"] == "both":
                left += second
            errs["ffd_scan_window_batched"] = max(errs["ffd_scan_window_batched"], e)
            errs["verdict_rows"] = max(errs["verdict_rows"], e_rows)
    if plans != {"pick", "window", "both"} or not left:
        fail(f"the frontier cases showed the plans {sorted(plans)} and {left} elements that "
             f"left the window")
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
    records = F.WINDOW_RECORDS = []
    F.reset_launches()
    card_runs, per_problem, per_records = {}, {}, {}
    try:
        for name, spec in specs.items():
            before, first = dict(F.LAUNCHES), len(records)
            for objective in OBJECTIVES:
                sched = TorchScheduler(spec["pools"], spec["inventory"],
                                       existing=spec["existing"], device="cuda",
                                       objective=objective)
                runs = [drive_verdicts(sched, spec)
                        for _ in range(1 + (TIMED_VERDICTS if objective == "nodes" else 0))]
                torch.cuda.synchronize()
                card_runs[(name, objective)] = (sched, runs)
            per_problem[name] = {k: F.LAUNCHES[k] - before[k] for k in VERDICT_KERNELS}
            per_records[name] = records[first:]
    finally:
        F.WINDOW_RECORDS = None
    launches = dict(F.LAUNCHES)
    print(f"  launches over the drive: {{{', '.join(f'{k!r}: {launches[k]}' for k in VERDICT_KERNELS)}}}"
          f", per problem {per_problem}")
    batched = [k for k in VERDICT_KERNELS if k.startswith("ffd_scan")]
    for name, got in per_problem.items():
        base = card_runs[(name, "nodes")][0]._removal_base(tuple(specs[name]["universe"]))
        plan = F.batch_launches(base.args[11], *pack_shapes(base.args))
        for k in (*plan, *VERDICT_FUNCTION):
            if got[k] <= 0:
                fail(f"{name}: {k} launched no time in the drive")
        if any(got[k] for k in batched if k not in plan):
            fail(f"{name}: batched scans launched {got}, expected only {plan}")
        print(f"  {name}: the batched scans ran as {plan} (fused_packer.batch_launches)")
        window_report(torch, f"{name} drive", per_records[name])
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
    for k, v in (*compare_tie_cases(torch).items(), *compare_batch_limit(torch).items(),
                 *compare_frontier_cases(torch).items()):
        errs[k] = max(errs.get(k, 0.0), v)
    # times, bounds and floors
    threads = sorted({F.scan_threads(pack_shapes(t[0].args)[0]) for t in timing.values()}
                     | {F.WINDOW_THREADS})
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
        if "ffd_scan_window_batched" in t:
            bounds["ffd_scan_window_batched"] = b_scan
            batched_floor_ms(torch, name, base, B, barrier_us[F.WINDOW_THREADS], l2_us,
                             kernel="ffd_scan_window")
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
              "ffd_scan_window_batched", "verdict_rows", "population_prologue"):
        if f not in errs:
            fail(f"phase 6 never compared {f}")
    # the window scan's row is measured at phase 9's base
    return {k: dict(figures.get(k, {}), launches=launches[k],
                    err=errs[VERDICT_FUNCTION.get(k, k)]) for k in VERDICT_KERNELS}



# ---------------------------------------------------------------------------
# Phase 7: the operator's provisioning loop
# ---------------------------------------------------------------------------


def operator_env(device: str, fastpath: bool = False, bypass: bool = False):
    """The port's operator environment over config 2's catalog, its
    ``general`` and tainted ``dedicated`` pools and a default NodeClass,
    the Provisioner's solver on ``device``.  The pools' consolidate_after
    outlasts the drive: the disruption controller runs every tick and
    takes no action.  Its drift feature gate is off: the drift check asks
    the cloud for every node's instance each tick, one batch window a
    node (phase 9 runs it).  Launches go one at a time in
    claim order (the simulator's determinism knob), so a card run and a
    CPU run hand out the same instance ids.  ``fastpath`` switches on the
    admission fast path, ``bypass`` the singleton bypass (a lone fresh pod
    goes to the batched solve at once instead of waiting out the batch
    window)."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.api import Disruption, Settings, reset_name_sequences
    from karpenter_tpu_torch.cloud.fake.catalog import generate_catalog

    reset_name_sequences()
    settings = Settings(cluster_name="chip-smoke", enable_admission_fastpath=fastpath,
                        provision_fastpath_bypass=bypass, enable_pipelined_reconcile=False,
                        feature_gate_drift=False)
    env = T.Environment(shapes=generate_catalog(**T.CONFIG2_CATALOG), settings=settings,
                        device=device)
    env.default_node_class()
    hold = lambda: Disruption(consolidate_after=HOLD_CONSOLIDATION_S)
    env.default_node_pool(name="general", disruption=hold())
    env.default_node_pool(name="dedicated", taints=[T.DEDICATED_TAINT], disruption=hold())
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


# ---------------------------------------------------------------------------
# Phase 8: single-pod arrivals through the admission fast path
# ---------------------------------------------------------------------------


class AdmitTimer:
    """Wraps ``fastpath.try_admit`` for a drive: each attempt's outcome,
    reason, wall ms on the host clock (an attempt ends with its [K+2]
    fetch) and its phases (delta: the resident refresh; dispatch;
    device_block; oracle; decode; the rest is the eligibility checks)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from karpenter_tpu_torch.scheduling import fastpath
        from karpenter_tpu_torch.utils.trace import phase_collect

        self._mod, self._orig = fastpath, fastpath.try_admit

        def timed(scheduler, pods):
            sink = {}
            t0 = time.perf_counter()
            with phase_collect(sink):
                res = self._orig(scheduler, pods)
            self.calls.append({"outcome": res.outcome, "reason": res.reason,
                               "ms": (time.perf_counter() - t0) * 1e3,
                               "phases_ms": {k: v * 1e3 for k, v in sink.items()}})
            return res

        fastpath.try_admit = timed
        return self

    def __exit__(self, *exc):
        self._mod.try_admit = self._orig


def live_headroom_cpu(env) -> float:
    """The most vCPU any live node has free (allocatable less its bound
    pods' requests)."""
    used = {}
    for p in env.kube.pods.values():
        if p.node_name:
            used[p.node_name] = used.get(p.node_name, 0.0) + p.requests.cpu
    return max((n.allocatable.cpu - used.get(name, 0.0) for name, n in env.kube.nodes.items()),
               default=0.0)


def fastpath_counts(reg) -> dict:
    """The fast path's counters: outcomes, fallback reasons, mismatches."""
    read = lambda name: {dict(k).get("outcome", dict(k).get("reason", "")): v
                         for k, v in reg.counters.get(name, {}).items()}
    return {"outcome": read("karpenter_admission_fastpath_total"),
            "reason": read("karpenter_admission_fastpath_fallback_total"),
            "mismatch": sum(reg.counters.get("karpenter_admission_fastpath_mismatch_total",
                                             {}).values())}


def arrival_plan(pods, live_headroom, arrivals: int = ARRIVALS, bursts: int = BURSTS,
                 oversized: int = OVERSIZED):
    """Phase 8's arrivals, one entry a tick: ``(kind, pods)``.
    ``arrivals`` single pods of the shapes of pods drawn from ``pods``
    (seed `ARRIVAL_SEED`); after every `BURST_EVERY`-th single a burst of
    2-8 pods of one drawn shape and a quiet tick (a burst the batched path
    waits a window for is placed before the next arrives), ``bursts`` in
    all; after every `OVERSIZED_EVERY`-th single a pod of `OVERSIZED_CPU`
    vCPU or more, past every live node's headroom (``live_headroom()``
    reads it when the entry comes, and its entry is a callable that makes
    the pod), ``oversized`` in all; the ones left over go at the end."""
    import random

    from karpenter_tpu_torch.api import Pod, Resources

    def shaped(name, tpl):
        return Pod(name=name, requests=tpl.requests, node_selector=dict(tpl.node_selector),
                   tolerations=list(tpl.tolerations))

    def big(o):
        def make():
            cpu = max(OVERSIZED_CPU, float(int(live_headroom())) + 1.0)
            return [Pod(name=f"oversized-{o}", requests=Resources(cpu=cpu, memory="4Gi"))]
        return ("oversized", make)

    rng = random.Random(ARRIVAL_SEED)
    singles = [shaped(f"arrival-{i:03d}", rng.choice(pods)) for i in range(arrivals)]
    queued = []
    for b in range(bursts):
        tpl, n = rng.choice(pods), rng.randint(*BURST_SIZES)
        queued.append([shaped(f"burst-{b:02d}-{j}", tpl) for j in range(n)])
    plan, o = [], 0
    for i, pod in enumerate(singles):
        plan.append(("single", [pod]))
        if (i + 1) % BURST_EVERY == 0 and queued:
            plan += [("burst", queued.pop(0)), ("quiet", [])]
        if (i + 1) % OVERSIZED_EVERY == 0 and o < oversized:
            plan.append(big(o))
            o += 1
    for b in queued:
        plan += [("burst", b), ("quiet", [])]
    plan += [big(k) for k in range(o, oversized)]
    return plan


def drive_arrivals(device: str, fastpath: bool = True, n_pods: int = OPERATOR_PODS,
                   arrivals: int = ARRIVALS, bursts: int = BURSTS, oversized: int = OVERSIZED,
                   cut: int = 0, stop_at_cut: bool = False, launches=None, at_cut=None):
    """Phase 8's drive on ``device``: config 2's first ``n_pods`` pods into
    the store and ticks until every pod is bound (phase 7's start), then a
    seeded `HEADROOM_SHARE` of the bound pods deleted (numpy
    ``default_rng(HEADROOM_SEED)``, uniformly over pods, so that most
    arrivals fit a live node), then `arrival_plan`'s entries (``arrivals``
    singles, ``bursts`` bursts, ``oversized`` oversized pods), one a tick
    of `TICK_S` of fake clock, and up to three ticks while arrivals are
    pending.  ``at_cut(env)`` runs after the tick of entry ``cut``; with
    ``stop_at_cut`` the drive ends there, so that its state compares with
    a full drive's at that tick.  The singleton bypass is on, the fast
    path as ``fastpath`` says.  Every tick's line carries its arrival
    kind and the fast-path outcomes it counted.  Returns (env, tick
    summaries)."""
    import numpy as np

    from karpenter_tpu_torch import testing as T

    env = operator_env(device, fastpath=fastpath, bypass=True)
    pods = T.heterogeneous_pods(n_pods)
    for p in pods:
        env.kube.put_pod(p)
    ticks = []

    def run_tick(kind):
        before = fastpath_counts(env.registry)["outcome"]
        t = operator_tick(env, len(ticks) + 1, launches)
        after = fastpath_counts(env.registry)["outcome"]
        t["arrival"] = kind
        t["fastpath"] = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        ticks.append(t)

    for _ in range(MAX_BIND_TICKS):
        run_tick("batch")
        if not env.kube.pending_pods():
            break
    if env.kube.pending_pods():
        fail(f"phase 8 ({device}): {len(env.kube.pending_pods())} pods unbound")
    bound = sorted(k for k, p in env.kube.pods.items() if p.node_name)
    rng = np.random.default_rng(HEADROOM_SEED)
    for i in sorted(rng.choice(len(bound), size=int(len(bound) * HEADROOM_SHARE),
                               replace=False)):
        env.kube.delete_pod(bound[i])
    plan = arrival_plan(pods, lambda: live_headroom_cpu(env), arrivals, bursts, oversized)
    for n, (kind, new) in enumerate(plan[:cut] if stop_at_cut else plan):
        for p in new() if callable(new) else new:
            env.kube.put_pod(p)
        run_tick(kind)
        if n + 1 == cut and at_cut is not None:
            at_cut(env)
    for _ in range(0 if stop_at_cut else 3):
        if env.kube.pending_pods():
            run_tick("settle")
    if env.kube.pending_pods() and not stop_at_cut:
        fail(f"phase 8 ({device}): {len(env.kube.pending_pods())} arrivals unbound")
    errors = env.registry.counters.get("karpenter_controller_reconcile_errors_total", {})
    if errors:
        fail(f"phase 8 ({device}): controller reconcile errors {dict(errors)}")
    return env, ticks


def percentiles(xs) -> dict:
    """p50 and p99 (nearest rank) of ``xs``, with the count."""
    if not xs:
        return {"n": 0}
    v = sorted(xs)
    return {"n": len(v), "p50": statistics.median(v),
            "p99": v[min(len(v) - 1, int(0.99 * len(v)))]}


def admit_args(args):
    """``admit_kernel``'s inputs from a pack's arguments: req, cnt, feas,
    alloc, openable, used0, cfg0."""
    return tuple(args[i] for i in (0, 1, 4, 5, 7, 8, 9))


def admit_bound(args, g: int) -> dict:
    """``admit_kernel``'s least time for class ``g`` on this run's data.
    The open-capacity bit is an any(): the configs up to and including the
    first that fits settle it (all of them when none fits).  Bytes: the
    class's req row and count, cfg0, its feasibility bytes at the live
    slots' configs and at those configs, openable where such a config's
    byte is set, the requested axes of alloc and used0 of each slot the
    class may use (a live slot with a feasible config), the requested axes
    of alloc of each such config it may open on, the [K+2] output.
    Operations: per such slot the capacity (sub, div, add, floor, min a
    requested axis) and the prefix and clip (3); per such config the
    capacity without the sub (4 a requested axis) and its test (1)."""
    import numpy as np

    from karpenter_tpu_torch.ops.packer import _per_node_cap

    req, cnt, feas, alloc, openable, used0, cfg0 = (t.cpu() for t in args)
    fits = (feas[g] & openable & (_per_node_cap(alloc, req[g]) > 0)).numpy()
    req, feas, openable, cfg0 = (t.numpy() for t in (req, feas, openable, cfg0))
    K = cfg0.shape[0]
    ru = int((req[g] > 0).sum())
    live = cfg0[cfg0 >= 0]
    slots = int(feas[g][live].sum())
    first = int(np.argmax(fits)) if fits.any() else fits.shape[0] - 1
    swept = np.arange(first + 1)
    configs = int((feas[g][swept] & openable[swept]).sum())
    feas_bytes = np.union1d(live, swept).size
    byts = (req.shape[1] * 4 + 4 + K * 4 + feas_bytes + int(feas[g][swept].sum())
            + slots * ru * 8 + configs * ru * 4 + (K + 2) * 4)
    ops = slots * (5 * ru + 3) + configs * (4 * ru + 1)
    return _bound(byts, ops)


def compare_admit(torch, name, args) -> float:
    """``admit`` against ``admit_reference`` for every class of ``args``
    (card tensors), bit for bit; one launch each.  Returns the largest
    error."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    err = 0.0
    G = args[0].shape[0]
    for g in range(G):
        before = F.LAUNCHES["admit_kernel"]
        got = F.admit(*args, g)
        torch.cuda.synchronize()
        if F.LAUNCHES["admit_kernel"] != before + 1:
            fail(f"{name}: admit for class {g} did not launch admit_kernel once")
        err = max(err, max_abs_err(torch, [got], [P.admit_reference(*args, g)]))
    print(f"  admit_kernel {name}: Gp={G} Kp={args[5].shape[0]} Cp={args[3].shape[0]} "
          f"R={args[0].shape[1]}: every class, max_abs_err={err!r}")
    if err != 0:
        fail(f"{name}: admit_kernel disagrees with admit_reference")
    return err


def time_admit(torch, name, args, g: int, card) -> dict:
    """``admit_kernel``'s device ms a launch (torch.profiler), a
    back-to-back wrapper call (CUDA events), the plain version's ms (CUDA
    events) and the bound, for class ``g``."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    call = lambda: F.admit(*args, g)
    out = {"ms": profiled_ms(torch, call, "admit", iters=ADMIT_ITERS),
           "call_ms": cuda_ms(torch, call, iters=ADMIT_ITERS),
           "plain_ms": cuda_ms(torch, lambda: P.admit_reference(*args, g), iters=20),
           "bound": admit_bound(args, g)}
    print(f"  admit_kernel {name} class {g}: kernel {out['ms']!r} ms device (profiler), "
          f"{out['call_ms']!r} ms a back-to-back call (CUDA events), plain {out['plain_ms']!r} ms "
          f"(CUDA events), bound {out['bound']} ({card})", flush=True)
    return out


def arrivals_phase(torch, card, live_args, twins):
    """Phase 8 as the module docstring lists it.  ``live_args``: phase 5's
    live cluster's pack arguments on the card; ``twins``: the `CpuTwins`
    that runs the CPU drive.  Returns the kernels-line figures of
    ``admit_kernel``."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    at_cut = {}

    def snapshot(env):
        at_cut["state"] = T.operator_state(env)
        at_cut["placed"] = placed(env)
        at_cut["outcomes"] = fastpath_outcomes(env.registry)

    F.reset_launches()
    t0 = time.perf_counter()
    with AdmitTimer() as timer:
        env, ticks = drive_arrivals("cuda", cut=ARRIVAL_CUT, launches=F.LAUNCHES,
                                    at_cut=snapshot)
    torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)
    card_s = time.perf_counter() - t0
    counts = fastpath_counts(env.registry)
    print(f"  {len(ticks)} ticks in {card_s!r} s; fast path {json.dumps(counts)}; launches over "
          f"the drive {json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    for t in ticks:
        if t["arrival"] in ("batch", "oversized", "settle") or t["tick"] <= 4:
            print("  tick " + json.dumps(t))
    if counts["mismatch"] or counts["outcome"].get("mismatch"):
        fail(f"phase 8: the fast path counted a mismatch {counts}")
    singles = [t for t in ticks if t["arrival"] == "single"]
    nominated_singles = sum(1 for t in singles if t["fastpath"].get("nominated"))
    print(f"  single arrivals nominated by the fast path: {nominated_singles} of {len(singles)}")
    if 2 * nominated_singles < len(singles):
        fail(f"phase 8: the fast path nominated {nominated_singles} of {len(singles)} "
             f"single arrivals, fewer than half")
    dispatched = sum(1 for c in timer.calls if "dispatch" in c["phases_ms"])
    if launches["admit_kernel"] != dispatched or not dispatched:
        fail(f"phase 8: {launches['admit_kernel']} admit_kernel launches on the card for "
             f"{dispatched} scored attempts")
    st = env.operator.provisioner.scheduler._resident.states[-1]
    if st.d_req.device.type != "cuda":
        fail("phase 8: the resident state is not on the card")
    reg = env.registry
    latency = {path: percentiles(reg.histogram("karpenter_admission_latency_seconds",
                                               {"path": path})) for path in ("fast", "batch")}
    print(f"  karpenter_admission_latency_seconds by path (fake clock, pending to nominated): "
          f"{json.dumps(latency)}")
    nominated = [c for c in timer.calls if c["outcome"] == "nominated"]
    phases = sorted({k for c in nominated for k in c["phases_ms"]})
    print(f"  fast path attempts (host clock, ends with the [K+2] fetch, {card}): nominated "
          f"{json.dumps(percentiles([c['ms'] for c in nominated]))} ms; fallbacks "
          f"{json.dumps(percentiles([c['ms'] for c in timer.calls if c['outcome'] != 'nominated']))}"
          f" ms; phases p50 of the nominated "
          + json.dumps({k: statistics.median(c["phases_ms"].get(k, 0.0) for c in nominated)
                        for k in phases}))
    by_kind = {}
    for t in ticks:
        if t["arrival"] == "batch":
            continue
        kind = ("fast" if t["fastpath"].get("nominated") else t["solve"] or "none")
        by_kind.setdefault(f"{t['arrival']}:{kind}", []).append(t["tick_ms"])
    print(f"  tick ms by arrival and admission ({card}): "
          + json.dumps({k: percentiles(v) for k, v in sorted(by_kind.items())}), flush=True)

    # the CPU and fast-path-off drives run the plan's first ARRIVAL_CUT
    # entries: they must show every outcome and reason the card's full
    # drive shows, and equal the card's drive at that tick
    if not at_cut:
        fail(f"phase 8: the card's drive never reached entry {ARRIVAL_CUT}")
    full = fastpath_outcomes(env.registry)
    if not full <= at_cut["outcomes"]:
        fail(f"phase 8: the first {ARRIVAL_CUT} entries miss the outcomes "
             f"{sorted(full - at_cut['outcomes'])} of the card's drive")
    cpu = twins.get("arrivals")
    print(f"  the same drive on the CPU (plain version), cut to the first {ARRIVAL_CUT} "
          f"entries ({cpu['ticks']} ticks), in {cpu['seconds']!r} s (beside the card's drives, "
          f"in a process of its own)", flush=True)
    card_state, cpu_state = at_cut["state"], cpu["state"]
    for key in card_state:
        if card_state[key] != cpu_state[key]:
            fail(f"phase 8: the card's {key} differ from the CPU operator's at tick "
                 f"{cpu['ticks']}")
    if cpu["outcomes"] != at_cut["outcomes"]:
        fail("phase 8: the CPU drive's outcomes differ from the card's")
    print(f"  the card's state at tick {cpu['ticks']} equals the CPU drive's "
          f"({sum(card_state['event_counts'].values())} events; outcomes and reasons "
          f"{sorted(at_cut['outcomes'])}, every one of the full drive's; fast-path counters "
          f"{card_state['counters']['karpenter_admission_fastpath_total']})")
    t0 = time.perf_counter()
    off_env, off_ticks = drive_arrivals("cuda", fastpath=False, cut=ARRIVAL_CUT,
                                        stop_at_cut=True)
    if placed(off_env) != at_cut["placed"]:
        fail(f"phase 8: the placements at tick {len(off_ticks)} differ from the same drive "
             f"with the fast path off")
    off_kind = {}
    for t in off_ticks:
        if t["arrival"] != "batch":
            off_kind.setdefault(f"{t['arrival']}:{t['solve'] or 'none'}", []).append(t["tick_ms"])
    print(f"  the same drive on the card with the fast path off, cut to the first "
          f"{ARRIVAL_CUT} entries, in {time.perf_counter() - t0!r} s: every pod on the same "
          f"node; tick ms by arrival and solve ({card}): "
          + json.dumps({k: percentiles(v) for k, v in sorted(off_kind.items())}), flush=True)

    # the kernel: bit-equality and times at the main path's shapes
    state_args = admit_args(st.pack_args())
    live = admit_args(live_args)
    err = max(compare_admit(torch, "phase 8's resident state", state_args),
              compare_admit(torch, "the live cluster", live))
    for k in (256, 4096):
        err = max(err, compare_admit(torch, f"wrap k_slots={k}",
                                     admit_args(P.to_device(T.wrap_arrays(k), torch.device("cuda")))))
    for case in T.ADMIT_EDGE_CASES:
        err = max(err, compare_admit(torch, f"edge case {case}",
                                     P.to_device(T.admit_edge_arrays(case), torch.device("cuda"))))
    row = time_admit(torch, "phase 8's resident state", state_args, 0, card)
    live_row = time_admit(torch, "the live cluster", live, 0, card)
    floor = admit_floor(torch, state_args, row["ms"], card)
    admit_floor(torch, live, live_row["ms"], card)
    return dict(row, launches=launches["admit_kernel"], err=err, **floor)


def placed(env) -> dict:
    """Every pod's node (empty while pending)."""
    return {k: p.node_name for k, p in sorted(env.kube.pods.items())}


def fastpath_outcomes(reg) -> set:
    """The fast path's outcomes and fallback reasons a drive has shown."""
    counts = fastpath_counts(reg)
    return ({f"outcome:{k}" for k, v in counts["outcome"].items() if v}
            | {f"reason:{k}" for k, v in counts["reason"].items() if v})


def empty_launch_ms(torch, threads: int, iters: int) -> float:
    """Device ms of a launch of one block of ``threads`` threads that
    passes no barrier and stores one word a thread
    (``probe_barrier_kernel`` with 0 iterations, csrc/latency_probe.cu),
    from torch.profiler: what any one-block launch costs."""
    import ctypes

    from karpenter_tpu_torch.ops import _build

    lib = _build.load("latency_probe")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_barrier.argtypes, lib.probe_barrier.restype = [I, I, P, P], I
    out = torch.empty(1024, dtype=torch.int32, device="cuda")

    def launch():
        if lib.probe_barrier(threads, 0, out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream) != 0:
            fail("the empty probe launch failed")

    return profiled_ms(torch, launch, "probe_barrier", iters=iters)


def admit_loads(K: int, Cp: int, live_end: int) -> int:
    """``admit_kernel``'s dependent L2 load rounds at K slots and Cp
    configs whose live slots end at ``live_end``: `ADMIT_FIXED_LOADS`, and
    one for each further group of `ADMIT_SLOT_GROUP` slot rounds (a round
    is `fused_packer.admit_threads` slots) that holds a live slot."""
    from karpenter_tpu_torch.ops import fused_packer as F

    live_rounds = -(-live_end // F.admit_threads(K, Cp))
    return ADMIT_FIXED_LOADS + max(0, -(-live_rounds // ADMIT_SLOT_GROUP) - 1)


def admit_floor(torch, args, kernel_ms: float, card) -> dict:
    """``admit_kernel``'s latency floor at ``args``' shapes: an empty
    one-block launch at its thread count (`fused_packer.admit_threads`),
    plus its `ADMIT_BARRIERS` block barriers at that thread count and its
    `admit_loads` dependent L2 load rounds, each at the round trip
    csrc/latency_probe.cu measures here."""
    from karpenter_tpu_torch.ops import fused_packer as F

    K, C = args[5].shape[0], args[3].shape[0]
    threads = F.admit_threads(K, C)
    live = (args[6] >= 0).nonzero()
    live_end = int(live.max()) + 1 if live.numel() else 0
    loads = admit_loads(K, C, live_end)
    barrier_us, _, l2_us = probe_latencies(torch, [threads], [])
    empty = empty_launch_ms(torch, threads, ADMIT_ITERS)
    floor = empty + (ADMIT_BARRIERS * barrier_us[threads] + loads * l2_us) / 1e3
    print(f"  admit_kernel latency floor at Kp {K}, Cp {C} ({threads} threads, {card}): empty "
          f"one-block launch {empty!r} ms (profiler) + {ADMIT_BARRIERS} barriers x "
          f"{barrier_us[threads]!r} us + {loads} L2 loads x {l2_us!r} us = {floor!r} ms; "
          f"kernel / floor {kernel_ms / floor!r}, kernel / empty launch {kernel_ms / empty!r}",
          flush=True)
    return {"latency_floor_ms": floor, "empty_launch_ms": empty}


def cpu_twin_drives(phases, conn) -> None:
    """The CPU drives phases 8 and 9 are held to, in a process of their own
    (`CpuTwins`): phase 8's drive cut to `ARRIVAL_CUT` entries and phase
    9's drive, each sent back through ``conn`` as ``(name, readings)``, or
    ``("error", text)``."""
    import traceback

    import torch

    from karpenter_tpu_torch import testing as T

    torch.set_num_threads(CPU_TWIN_THREADS)
    try:
        if 8 in phases:
            t0 = time.perf_counter()
            env, ticks = drive_arrivals("cpu", cut=ARRIVAL_CUT, stop_at_cut=True)
            conn.send(("arrivals", {"state": T.operator_state(env), "ticks": len(ticks),
                                    "outcomes": fastpath_outcomes(env.registry),
                                    "seconds": time.perf_counter() - t0}))
        if 9 in phases:
            t0 = time.perf_counter()
            env, _before, ticks, events, _ = drive_consolidation("cpu")
            conn.send(("consolidation", {"state": T.operator_state(env), "ticks": len(ticks),
                                         "events": events,
                                         "seconds": time.perf_counter() - t0}))
    except SystemExit as exc:
        conn.send(("error", f"exit {exc.code}"))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class CpuTwins:
    """`cpu_twin_drives` for ``phases`` in a spawned process, started at
    once so that it runs beside the card's drives; `get` waits for one
    drive's readings, `close` ends the process."""

    def __init__(self, phases):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=cpu_twin_drives, args=(tuple(phases), child),
                                 daemon=True)
        self._proc.start()
        child.close()
        self._got = {}

    def get(self, name: str) -> dict:
        while name not in self._got:
            try:
                key, value = self._conn.recv()
            except EOFError:
                fail(f"the CPU drives' process ended before sending {name}")
            if key == "error":
                fail(f"the CPU drives' process failed: {value}")
            self._got[key] = value
        return self._got[name]

    def close(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join()


# ---------------------------------------------------------------------------
# Phase 9: consolidation through the operator
# ---------------------------------------------------------------------------


def live_fleet(env) -> dict:
    """The live NodeClaims (not marked for deletion): count and summed price."""
    live = [c for c in env.kube.node_claims.values() if c.deleted_at is None]
    return {"nodes": len(live), "price": sum(c.price for c in live)}


def counter_sum(reg, name: str) -> float:
    return sum(reg.counters.get(name, {}).values())


def counter_by(reg, name: str, label: str) -> dict:
    """A counter's values summed by one label."""
    out = {}
    for k, v in reg.counters.get(name, {}).items():
        key = dict(k).get(label, "")
        out[key] = out.get(key, 0.0) + v
    return out


def drive_consolidation(device: str, n_pods: int = OPERATOR_PODS, launches=None,
                        profile_tick=None, bases=None):
    """Phase 9's drive on ``device``: `testing.consolidating_cluster` (config
    2's first ``n_pods`` pods bound, a seeded half deleted, consolidate_after lowered
    to a few ticks; the default Settings, so the pipelined schedule is on),
    then ticks of `TICK_S` until the disruption controller takes no action
    for `CONSOLIDATION_QUIET` ticks in a row with no pod pending, or
    `CONSOLIDATION_TICKS` ticks.  ``profile_tick(run_tick)`` runs a tick
    under the profiler and returns what it saw; it is asked for each tick
    until a profiled tick consolidates, at most `PROFILED_TICKS` times.
    Each tick's line carries its disruption actions, its speculation
    outcomes and the ledger's ``NodeDisrupted`` / ``VerdictFallback``
    events.  Returns (env, the fleet before, tick summaries, the events in
    order, the profiled ticks).  ``bases``: a list that gets each removal
    base the disruption controller's scheduler builds, in order."""
    from karpenter_tpu_torch import testing as T

    env = T.consolidating_cluster(device, n_pods=n_pods)
    reg = env.registry
    before = live_fleet(env)
    ticks, events, profiled = [], [], []
    seen = [max((ev.seq for ev in env.operator.ledger.recent(limit=1 << 30)), default=0)]

    def run_tick():
        actions0 = counter_sum(reg, "karpenter_deprovisioning_actions")
        spec0 = counter_by(reg, "karpenter_pipeline_speculation_total", "outcome")
        t = operator_tick(env, len(ticks) + 1, launches)
        t["actions"] = counter_sum(reg, "karpenter_deprovisioning_actions") - actions0
        spec = counter_by(reg, "karpenter_pipeline_speculation_total", "outcome")
        t["speculation"] = {k: v - spec0.get(k, 0) for k, v in spec.items() if v != spec0.get(k, 0)}
        new = [ev for ev in env.operator.ledger.recent(limit=1 << 30) if ev.seq > seen[0]]
        if new:
            seen[0] = new[-1].seq
        mine = [(ev.ts, ev.type, sorted(ev.attrs.items())) for ev in new
                if ev.type in T.DISRUPTION_EVENTS]
        t["disrupted"] = sum(1 for e in mine if e[1] == "NodeDisrupted")
        t["fallbacks"] = sum(1 for e in mine if e[1] == "VerdictFallback")
        t["pending"] = len(env.kube.pending_pods())
        events.extend(mine)
        ticks.append(t)
        if bases is not None:
            for entry in env.operator.disruption._scheduler._removal_cache.values():
                if all(entry[0] is not b for b in bases):
                    bases.append(entry[0])

    quiet = 0
    for _ in range(CONSOLIDATION_TICKS):
        if (profile_tick is not None and len(profiled) < PROFILED_TICKS
                and not any(p["actions"] for p in profiled)):
            prof = profile_tick(run_tick) or {}
            profiled.append(dict(prof, tick=len(ticks), actions=ticks[-1]["actions"]))
        else:
            run_tick()
        quiet = 0 if ticks[-1]["actions"] else quiet + 1
        if quiet >= CONSOLIDATION_QUIET and not env.kube.pending_pods():
            break
    if env.kube.pending_pods():
        fail(f"phase 9 ({device}): {len(env.kube.pending_pods())} pods unbound after "
             f"{len(ticks)} ticks")
    errors = reg.counters.get("karpenter_controller_reconcile_errors_total", {})
    if errors:
        fail(f"phase 9 ({device}): controller reconcile errors {dict(errors)}")
    return env, before, ticks, events, profiled


def consolidation_base(torch, card, bases) -> dict:
    """Phase 9's base: of the removal bases the drive built, the one at the
    largest Kp (the last of them), with the first round of a `SearchPlan`
    pass over its universe (`BASE_POPULATION` members, the controller's
    objective "cost") as its batch, through `population_prologue` on the
    card.  Prints its launch group (`window_report`); holds
    `ffd_scan_batch` (the window scan and the picked scan after it) and the
    picked scan on every element (the parent's batched scan) to the plain
    version bit for bit; prints the batched scan's bound and both latency
    floors at these shapes; times the two in turns (parent, new, new,
    parent: profiler ms a launch of each kernel and CUDA-event ms a call).
    Returns the window scan's kernels-line figures."""
    import numpy as np

    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P
    from karpenter_tpu_torch.scheduling.popsearch import SearchPlan
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    usable = [b for b in bases if b.args and not (b.reason or b.empty or b.pop_reason)]
    if not usable:
        fail("phase 9: the drive built no removal base with a population path")
    base = max(reversed(usable), key=lambda b: b.kp)
    (req, _, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = base.args
    U = base.cand_slot.shape[0]
    keys = SearchPlan(U, [1.0] * U, [False] * U, BASE_POPULATION, SEARCH_ROUNDS,
                      BASE_SEED).propose()
    pp = P._bucket(len(keys), floor=TorchScheduler.MIN_REMOVAL_BATCH)
    masks = key_masks(keys, U)
    masks = np.concatenate([masks, np.zeros((pp - len(keys), U), bool)])
    pop = (base.cand_cnt, base.cand_slot, base.cand_occ, base.sort_rank, base.occ_span,
           torch.from_numpy(masks).to(used0.device), base.k_slots)
    cnt_b, rm_b, perm_b = F.population_prologue(*pop)
    chosen = F.choose_config(req, maxper, feas, alloc, price, openable, "cost")
    scan_args = (req, maxper, slot, feas, alloc, *chosen, used0, cfg0, npods0, next0, sig0,
                 cnt_b, rm_b, perm_b)
    shapes = K, R, S, C = batch_shapes(scan_args)
    B = perm_b.shape[0]
    plan = F.batch_launches(next0, *shapes)
    picked = F.scan_kernel(*shapes)
    print(f"  phase 9's base ({len(bases)} built; the last at the largest Kp): B={B} "
          f"Gp={req.shape[0]} Kp={K} Cp={C} R={R} S={S} next0={next0}, universe {U}; "
          f"launches {plan}", flush=True)
    F.WINDOW_RECORDS = []
    try:
        outs, moved = launches_of(torch, lambda: F.ffd_scan_batch(*scan_args))
        records = F.WINDOW_RECORDS
    finally:
        F.WINDOW_RECORDS = None
    if moved != dict.fromkeys(plan, 1):
        fail(f"phase 9's base: the batched scan launched {moved}, expected {plan}")
    window_report(torch, "phase 9's base", records, each=True)
    parent = forced_scan(F, scan_args)
    want = P.ffd_scan_batch_reference(*scan_args)
    err = max_abs_err(torch, outs, want)
    err_parent = max_abs_err(torch, parent(), want)
    print(f"  phase 9's base: ffd_scan_batch ({'+'.join(plan)}) max_abs_err={err!r}, "
          f"{picked}_batched on every element max_abs_err={err_parent!r}")
    if err != 0 or err_parent != 0:
        fail("phase 9's base: a batched scan disagrees with its plain version")
    bound = batched_scan_bound(torch, scan_args, outs)
    print(f"  phase 9's base batched scan bound: {bound} ({card})")
    clusters = []
    if picked == "ffd_scan_cluster":
        ctas = F.cluster_layout(*shapes)[0]
        clusters = [(ctas, F.scan_threads(-(-K // ctas)))]
    barrier_us, cluster_us, l2_us = probe_latencies(
        torch, sorted({F.WINDOW_THREADS, F.scan_threads(K)}), clusters)
    floor = batched_floor_ms(torch, "phase 9's base", base, B, barrier_us[F.WINDOW_THREADS],
                             l2_us, kernel="ffd_scan_window")
    batched_floor_ms(torch, "phase 9's base", base, B,
                     cluster_us[clusters[0]] if clusters else barrier_us[F.scan_threads(K)],
                     l2_us)
    # CUDA events around back-to-back calls, each side: the profiler records
    # no device time for the batched cluster scan at these shapes (PERF.md §7)
    args14 = (req, cnt_b[0], *scan_args[1:13])
    shapes5 = (req.shape[0], C, K, R, S)
    batch = (B, perm_b, cnt_b, rm_b)
    done = torch.empty(B, dtype=torch.int32, device=used0.device)
    scratch = F._scan_outputs(req.shape[0], K, R, used0.device, (B,))
    layout = F.window_layout(*shapes)
    sides = {
        "parent": parent,
        "window": lambda: F._launch_window(args14, shapes5, layout, batch, done, scratch),
        "after": lambda: F._launch_picked(args14, shapes5, (*batch, done), scratch),
        "call": lambda: F.ffd_scan_batch(*scan_args),
    }
    if plan[-1] == "ffd_scan_window_batched":
        del sides["after"]
    turns = {k: [] for k in sides}
    for side in ("parent", "new", "new", "parent"):
        for k in (("parent",) if side == "parent" else [k for k in sides if k != "parent"]):
            turns[k].append(cuda_ms(torch, sides[k], iters=BASE_ITERS, warmup=1))
        print(f"  phase 9's base in turns, {side}: ms a call (CUDA events) "
              f"{json.dumps({k: v[-1] for k, v in turns.items() if v})} ({card})", flush=True)
    mean = {k: statistics.mean(v) for k, v in turns.items()}
    print(f"  phase 9's base: the parent's {picked}_batched {mean['parent']!r} ms a launch; the "
          f"window scan {mean['window']!r} ms, the launch after it {mean.get('after')!r} ms "
          f"({int(done.sum())} of {B} elements done), ffd_scan_batch {mean['call']!r} ms a call; "
          f"parent / call {mean['parent'] / mean['call']!r}x; bound {bound['bound_ms']!r} ms, "
          f"window floor {floor!r} ms (CUDA events, {card})")
    window_ms = mean["window"]
    seen = profile_solve(torch, lambda _: parent(), None)
    print(f"  phase 9's base: torch.profiler over one call of the parent's "
          f"{picked}_batched saw " + (json.dumps(seen["top_device_events"]) if seen
                                      else "no device time"))
    plain_ms = cuda_ms(torch, lambda: P.ffd_scan_batch_reference(*scan_args), iters=1, warmup=1)
    return dict(ms=window_ms, plain_ms=plain_ms, bound=bound, floor=floor, err=err,
                argsort_ms=None)


def consolidation_phase(torch, card, twins):
    """Phase 9 as the module docstring lists it; ``twins``: the `CpuTwins`
    that runs the CPU drive.  Returns the launch counts of the card's drive
    and the window scan's figures at its base (`consolidation_base`)."""
    from karpenter_tpu_torch import testing as T
    from karpenter_tpu_torch.ops import fused_packer as F

    def profiled_tick(run_tick):
        torch.cuda.synchronize()
        return profile_solve(torch, lambda _: run_tick(), None)

    F.reset_launches()
    bases, records = [], []
    F.WINDOW_RECORDS = records
    t0 = time.perf_counter()
    try:
        env, before, ticks, events, profiled = drive_consolidation(
            "cuda", launches=F.LAUNCHES, profile_tick=profiled_tick, bases=bases)
        torch.cuda.synchronize()
    finally:
        F.WINDOW_RECORDS = None
    launches = dict(F.LAUNCHES)
    card_s = time.perf_counter() - t0
    reg = env.registry
    after = live_fleet(env)
    for t in ticks:
        if t["actions"] or t["tick"] <= 3 or t["fallbacks"]:
            print("  tick " + json.dumps(t))
    actions = counter_by(reg, "karpenter_deprovisioning_actions", "mechanism")
    reasons = {}
    for _ts, kind, attrs in events:
        if kind == "NodeDisrupted":
            r = dict(attrs).get("reason", "")
            reasons[r] = reasons.get(r, 0) + 1
    evals = counter_by(reg, "karpenter_consolidation_evals_total", "path")
    spec = counter_by(reg, "karpenter_pipeline_speculation_total", "outcome")
    disruption_ms = [t["controllers_ms"]["disruption"] for t in ticks]
    acting = [t["tick_ms"] for t in ticks if t["actions"]]
    idle = [t["tick_ms"] for t in ticks if not t["actions"]]
    print(f"  {len(ticks)} ticks in {card_s!r} s ({card}; the 10,000-pod bind and the deletions "
          f"before them not counted, the tick lines above in ms on the same card); launches "
          f"over the drive "
          f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    print(f"  nodes {before['nodes']} -> {after['nodes']}, summed node price "
          f"{before['price']!r} -> {after['price']!r} per hour")
    print(f"  actions by mechanism {json.dumps(actions)}; NodeDisrupted by reason "
          f"{json.dumps(reasons)}; VerdictFallback events "
          f"{sum(1 for e in events if e[1] == 'VerdictFallback')}")
    print(f"  karpenter_consolidation_evals_total by path {json.dumps(evals)}; search winners "
          f"{json.dumps(counter_by(reg, 'karpenter_consolidation_search_winners_total', 'action'))}")
    print(f"  disruption reconcile ms ({card}): {json.dumps(percentiles(disruption_ms))}; "
          f"tick ms of the ticks that consolidate {json.dumps(percentiles(acting))}, of those "
          f"that do not {json.dumps(percentiles(idle))}")
    print(f"  speculation outcomes (pipelined schedule): {json.dumps(spec)}")
    for p in profiled:
        print(f"  profiled tick {p['tick']} (torch.profiler, {card}, {p['actions']} actions): "
              + json.dumps({k: v for k, v in p.items() if k not in ("tick", "actions")}))
    if not any(p.get("actions") and p.get("device_busy_share") is not None for p in profiled):
        fail("phase 9: no profiled tick consolidated with device time seen")
    mismatch = counter_sum(reg, "karpenter_consolidation_verdict_mismatch_total")
    if not sum(actions.values()):
        fail("phase 9: the drive took no consolidation action")
    if mismatch:
        fail(f"phase 9: {mismatch} verdict mismatches")
    for k in CONSOLIDATION_KERNELS:
        if not launches[k]:
            fail(f"phase 9: {k} never launched through the operator")
    batched = {k: launches[k] for k in ("ffd_scan_batched", "ffd_scan_cluster_batched",
                                        "ffd_scan_window_batched")}
    if not batched["ffd_scan_window_batched"]:
        fail(f"phase 9: the frontier-window scan never launched through the operator {batched}")
    if launches["ffd_scan_global_batched"]:
        fail(f"phase 9: ffd_scan_global_batched launched {launches['ffd_scan_global_batched']} "
             f"times")
    window_report(torch, "phase 9", records, each=True)
    planned = {k: 0 for k in batched}
    for r in records:
        for k in F.batch_launches(r["next0"], r["Kp"], r["R"], r["S"], r["Cp"]):
            planned[k] = planned.get(k, 0) + 1
    if planned != batched:
        fail(f"phase 9: the batched launches {batched} are not those the launch groups' plans "
             f"make {planned}")
    cache = list(env.operator.disruption._scheduler._removal_cache.values())
    base = cache[-1] if cache else None
    if base is not None and base[0].args:
        picked = F.scan_kernel(*pack_shapes(base[0].args))
        print(f"  the last removal base (Kp {base[0].kp}, Gp {base[0].gp}) picks {picked}: the "
              f"batched launches over the drive {batched}")
    cpu = twins.get("consolidation")
    print(f"  the same drive on the CPU (plain versions): {cpu['ticks']} ticks in "
          f"{cpu['seconds']!r} s (beside the card's drives, in a process of its own)", flush=True)
    if cpu["ticks"] != len(ticks):
        fail(f"phase 9: the CPU drive ran {cpu['ticks']} ticks, the card's {len(ticks)}")
    if cpu["events"] != events:
        fail("phase 9: the ledger's NodeDisrupted / VerdictFallback events differ from the "
             "CPU drive's")
    card_state, cpu_state = T.operator_state(env), cpu["state"]
    for key in card_state:
        if card_state[key] != cpu_state[key]:
            fail(f"phase 9: the card's {key} differ from the CPU operator's")
    print(f"  the card's NodeClaims created and deleted, bindings, cloud calls, ledger "
          f"({len(events)} NodeDisrupted / VerdictFallback events in order) and solver and "
          f"disruption counters equal the CPU operator's")
    return launches, consolidation_base(torch, card, bases)


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
    phase_done(7, through)

    print(f"[arrivals] single-pod arrivals through the admission fast path, {card}", flush=True)
    twins = CpuTwins((8, 9) if through > 8 else (8,))
    try:
        admit = arrivals_phase(torch, card, kargs["config2_live"], twins)
        phase_done(8, through)

        print(f"[consolidation] the disruption controller through the operator, {card}",
              flush=True)
        consolidation, window_row = consolidation_phase(torch, card, twins)
    finally:
        twins.close()
    verdicts["ffd_scan_window_batched"].update(window_row, err=max(
        window_row["err"], verdicts["ffd_scan_window_batched"]["err"]))

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
            "consolidation_launches": consolidation[k],
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
            "consolidation_launches": consolidation[k],
            **({"argsort_ms": v["argsort_ms"]} if v["argsort_ms"] is not None else {}),
        })
    kernels.append({
        "name": "admit_kernel",
        "problem": ROW_PROBLEM["admit_kernel"],
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": ADMIT_REPLACES,
        "launches": admit["launches"],
        "max_abs_err": admit["err"],
        "ms": admit["ms"],
        "plain_ms": admit["plain_ms"],
        "bound_ms": admit["bound"]["bound_ms"],
        "bound_by": admit["bound"]["bound_by"],
        "library_ms": None,
        "latency_floor_ms": admit["latency_floor_ms"],
        "empty_launch_ms": admit["empty_launch_ms"],
        "operator_launches": op_launches["admit_kernel"],
        "consolidation_launches": consolidation["admit_kernel"],
        "call_ms": admit["call_ms"],
    })
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
