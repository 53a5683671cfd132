#!/usr/bin/env python3
"""Drive karpenter_tpu_torch on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Phases (each failure exits non-zero before the last line is printed):

1. Device: requires ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles every CUDA source of the package with ``nvcc`` (all at
   once) and prints the ``-Xptxas -v`` summary of each.
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
     boundary (cluster; at 4096 on every cluster size).
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
6. Prints the kernels JSON line, the card line, and last
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
KERNELS = ("choose_config", "ffd_scan", "ffd_scan_global", "ffd_scan_cluster")
SCAN_KERNELS = KERNELS[1:]
LIVE_NODES = 2000  # phase 5's live cluster: 2,000 + 256 slots -> 4096
# the problem each kernel's row of the kernels line is measured at: the one
# whose solves launch it (the global scan: where it ran before the cluster
# scan took that shape)
ROW_PROBLEM = {"choose_config": "config2", "ffd_scan": "config2",
               "ffd_scan_global": "config2_live", "ffd_scan_cluster": "config2_live"}
L2_PROBE_BYTES = 8 << 20  # pointer-chase buffer: past L1, well inside L2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


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


def _device_us(ev) -> float:
    dev_us = getattr(ev, "self_device_time_total", None)
    return dev_us if dev_us is not None else getattr(ev, "self_cuda_time_total", 0.0)


def profiled_ms(torch, fn, kernel: str, iters: int):
    """Mean device milliseconds per launch of ``kernel`` over ``iters``
    calls of ``fn``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if f"{kernel}_kernel" in ev.key and _device_us(ev) > 0:
            total_us += _device_us(ev)
            count += ev.count
    if not count:
        fail(f"torch.profiler saw no device time of {kernel}")
    return total_us / count / 1e3


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


def main() -> int:
    """The run as the module docstring lists it."""
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
    for k in KERNELS:
        if k not in errs:
            fail(f"phase 3 never ran {k}")

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
    for k, name in ROW_PROBLEM.items():
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

    kernels = []
    for k in KERNELS:
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
        })
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
