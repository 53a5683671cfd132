#!/usr/bin/env python3
"""Drive karpenter_tpu_torch on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Phases (each failure exits non-zero before the last line is printed):

1. Device: requires ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles every CUDA source of the package with ``nvcc`` (all at
   once) and prints the ``-Xptxas -v`` summary of each.
3. Kernel vs plain: on the config-2 (``heterogeneous_problem``) and flagship
   (``flagship_problem``) problems, for both objectives, each kernel
   (``choose_config``, ``ffd_scan``) runs beside its plain PyTorch version
   on the same card tensors; every output must be bit-equal.
4. Kernel times: each kernel's device time per launch (torch.profiler)
   and its CUDA-event time over many launches after warm-up, beside the
   plain versions' times (CUDA events) and each kernel's bound at this
   run's inputs.  The bound counts the bytes and operations this run's
   data needs; for ``ffd_scan`` the line also carries its latency floor,
   class steps x (barriers x barrier round trip + dependent L2 loads x L2
   round trip), with both round trips measured here by
   ``csrc/latency_probe.cu``.
5. The slice: ``TorchScheduler(device="cuda").solve`` on config 2 (10,000
   pods, 317 classes) and on the flagship, 2 warm-up + 10 timed solves each,
   with the launch counters set to 0 just before and read just after.  All
   pods must be placed through the kernels, and each problem's decoded
   result must equal a CPU solve through the plain version.
   One more solve per problem runs under torch.profiler, after the counts
   are read, for the device time of each kernel and the device's busy
   share of the solve.
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
KERNEL_SOURCE = "karpenter_tpu_torch/csrc/ffd_pack.cu"
REPLACES = "karpenter_tpu/ops/pallas_packer.py:99"  # _pack_step
# loads per class step of ffd_scan whose address or data the previous step
# decides and that no earlier step touched: the class's req row, and
# feas[g, cfg[k]] gathered through the slot's config
SCAN_L2_LOADS_PER_STEP = 2
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
        "config2": (pools, inv, pods),
        "flagship": ([pool], {pool.name: types}, fpods),
    }


def compiled(spec):
    from karpenter_tpu_torch.ops.tensorize import compile_problem

    pools, inv, pods = spec
    return compile_problem(pods, pools, inv)


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


def scan_threads(K: int) -> int:
    """Threads of the one ffd_scan block (``scan_threads`` in ffd_pack.cu)."""
    return min(max((K + 31) // 32 * 32, 32), 1024)


def scan_barriers_per_step(K: int) -> int:
    """Block barriers ffd_scan_kernel passes per class: one after loading
    the class's req row, three per chunk of the prefix scan, three in each
    of the two block sums."""
    return 1 + 3 * -(-K // scan_threads(K)) + 3 + 3


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
    sig_pairs = len({(int(slot[g]), int(k)) for g, k in zip(*np.nonzero(fits))})
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


def scan_latency_floor_ms(G: int, K: int, barrier_us: float, l2_us: float) -> float:
    """ffd_scan's floor as a chain of dependent class steps: each step
    passes its barriers and waits on its dependent L2 loads in turn."""
    step_us = scan_barriers_per_step(K) * barrier_us + SCAN_L2_LOADS_PER_STEP * l2_us
    return G * step_us / 1e3


def probe_latencies(torch, threads: int):
    """The barrier round trip of one block of ``threads`` threads and the
    dependent L2 load round trip, in microseconds, each from two launches
    of csrc/latency_probe.cu at different step counts (the difference
    cancels the launch)."""
    import ctypes

    import numpy as np

    from karpenter_tpu_torch.ops import _build

    lib = _build.load("latency_probe")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_barrier.argtypes, lib.probe_barrier.restype = [I, I, P, P], I
    lib.probe_chase.argtypes, lib.probe_chase.restype = [P, I, P, P], I
    dev = torch.device("cuda")
    out = torch.empty(1024, dtype=torch.int32, device=dev)
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

    barrier_us = per_step_us(
        lambda n, st: lib.probe_barrier(threads, n, out.data_ptr(), st), 20000, 220000)
    l2_us = per_step_us(
        lambda n, st: lib.probe_chase(chain.data_ptr(), n, out.data_ptr(), st),
        lines, 4 * lines)
    return barrier_us, l2_us


def compare_kernels(torch, prob, dev):
    """Phase 3 on one problem: each kernel against its plain version on the
    same card tensors, both objectives.  Returns the largest error."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    args = P.to_device(P.pad_problem(prob)[0], dev)
    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    errs = {"choose_config": 0.0, "ffd_scan": 0.0}
    nodes_out = None
    for objective in ("nodes", "cost"):
        chosen = F.choose_config(req, maxper, feas, alloc, price, openable, objective)
        torch.cuda.synchronize()
        plain = P.choose_config_reference(
            req, maxper, feas, alloc, price, openable, objective
        )
        torch.cuda.synchronize()
        e1 = max_abs_err(torch, chosen, plain)
        got = F.ffd_scan(req, cnt, maxper, slot, feas, alloc, *chosen,
                         used0, cfg0, npods0, next0, sig0)
        torch.cuda.synchronize()
        want = P.ffd_scan_reference(req, cnt, maxper, slot, feas, alloc, *plain,
                                    used0, cfg0, npods0, next0, sig0)
        torch.cuda.synchronize()
        e2 = max_abs_err(torch, got, want)
        print(f"  {objective}: choose_config max_abs_err={e1} ffd_scan "
              f"max_abs_err={e2} placed={int(got[0].sum())} "
              f"leftover={int(got[1].sum())} nodes={int((got[2] >= 0).sum())}")
        if e1 != 0 or e2 != 0:
            fail(f"kernel disagrees with its plain version ({objective})")
        errs["choose_config"] = max(errs["choose_config"], e1)
        errs["ffd_scan"] = max(errs["ffd_scan"], e2)
        if objective == "nodes":
            nodes_out = got
    return errs, args, nodes_out


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


def time_kernels(torch, args):
    """Phase 4: per kernel at one problem's shapes (nodes objective), its
    device ms per launch (profiler), its CUDA-event ms per call over
    back-to-back calls (the wrapper's host enqueue included where it is
    slower than the kernel), and its plain version's CUDA-event ms."""
    from karpenter_tpu_torch.ops import fused_packer as F
    from karpenter_tpu_torch.ops import packer as P

    (req, cnt, maxper, slot, feas, alloc, price, openable,
     used0, cfg0, npods0, next0, sig0) = args
    chosen = F.choose_config(req, maxper, feas, alloc, price, openable)
    scan_args = (req, cnt, maxper, slot, feas, alloc, *chosen,
                 used0, cfg0, npods0, next0, sig0)
    choose = lambda: F.choose_config(req, maxper, feas, alloc, price, openable)
    scan = lambda: F.ffd_scan(*scan_args)
    return {
        "choose_config": (
            profiled_ms(torch, choose, "choose_config", iters=200),
            cuda_ms(torch, choose, iters=200),
            cuda_ms(torch, lambda: P.choose_config_reference(
                req, maxper, feas, alloc, price, openable), iters=20),
        ),
        "ffd_scan": (
            profiled_ms(torch, scan, "ffd_scan", iters=50),
            cuda_ms(torch, scan, iters=50),
            cuda_ms(torch, lambda: P.ffd_scan_reference(*scan_args),
                    iters=3, warmup=1),
        ),
    }


def canonical(result):
    nodes = sorted(
        (vn.pool.name, tuple(t.name for t in vn.feasible_types),
         tuple(sorted(vn.zone_options())), tuple(sorted(p.name for p in vn.pods)))
        for vn in result.new_nodes
    )
    return nodes, sorted(result.existing_placements.items()), sorted(result.unschedulable)


def profile_solve(torch, sched, pods):
    """One more solve under torch.profiler: the device time of each of the
    port's kernels and of all device work, beside the solve's wall time.
    Returns None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.solve(pods)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {"choose_config": 0.0, "ffd_scan": 0.0}
    busy_us = 0.0
    for ev in prof.key_averages():
        dev_us = _device_us(ev)
        busy_us += dev_us
        for k in per_kernel:
            if f"{k}_kernel" in ev.key:
                per_kernel[k] += dev_us
    if busy_us <= 0:
        return None
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "kernel_device_ms": {k: v / 1e3 for k, v in per_kernel.items()},
    }


def drive_solves(torch, name, spec):
    """Phase 5 on one problem: warm-up + timed solves through the card."""
    from karpenter_tpu_torch.scheduling.solver import TorchScheduler

    pools, inv, pods = spec
    sched = TorchScheduler(pools, inv, device="cuda")
    times, result = [], None
    for i in range(WARMUP_SOLVES + TIMED_SOLVES):
        t0 = time.perf_counter()
        result = sched.solve(pods)
        torch.cuda.synchronize()
        if i >= WARMUP_SOLVES:
            times.append((time.perf_counter() - t0) * 1e3)
        placed = sum(len(n.pods) for n in result.new_nodes) + len(
            result.existing_placements
        )
        if placed != len(pods) or result.unschedulable:
            fail(f"{name}: placed {placed} of {len(pods)} pods")
        if sched.last_kernel != "cuda_ffd" or sched.last_path != "tensor":
            fail(f"{name}: path {sched.last_path}/{sched.last_kernel}")
    return sched, result, times


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
    errs, kargs, kouts = {}, {}, {}
    for name, prob in probs.items():
        print(f" {name}")
        e, kargs[name], kouts[name] = compare_kernels(torch, prob, dev)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    print(f"[kernel times] torch.profiler device time and CUDA events, {card}", flush=True)
    times = {name: time_kernels(torch, args) for name, args in kargs.items()}
    for name, t in times.items():
        for k, (dev_ms, ev_ms, plain) in t.items():
            print(f"  {name} {k}: kernel {dev_ms!r} ms device (profiler), "
                  f"{ev_ms!r} ms per call (CUDA events), plain {plain!r} ms (CUDA events)")
    c2 = kargs["config2"]
    take, _, node_cfg, _, _ = kouts["config2"]
    bounds = kernel_bounds(c2, take, node_cfg)
    G2, K2 = c2[0].shape[0], c2[8].shape[0]
    barrier_us, l2_us = probe_latencies(torch, scan_threads(K2))
    floor_ms = scan_latency_floor_ms(G2, K2, barrier_us, l2_us)
    print(f"  latency probes ({card}): barrier round trip {barrier_us!r} us "
          f"({scan_threads(K2)} threads), dependent L2 load {l2_us!r} us")
    print(f"  config2 ffd_scan latency floor: {G2} steps x ({scan_barriers_per_step(K2)} "
          f"barriers + {SCAN_L2_LOADS_PER_STEP} L2 loads) = {floor_ms!r} ms")
    for k, b in bounds.items():
        print(f"  config2 {k} bound: {b}")

    print(f"[slice] TorchScheduler.solve on the card, {card}", flush=True)
    F.reset_launches()
    solved = {name: drive_solves(torch, name, spec) for name, spec in specs.items()}
    launches = dict(F.LAUNCHES)
    n_solves = len(specs) * (WARMUP_SOLVES + TIMED_SOLVES)
    print(f"  launches over {n_solves} solves: {launches}")
    for k, n in launches.items():
        if n < n_solves:
            fail(f"kernel {k} launched {n} times over {n_solves} solves")
    for name, (sched, result, ts) in solved.items():
        print(f"  {name}: nodes={len(result.new_nodes)} "
              f"price={result.total_price()!r} p50_ms={statistics.median(ts)!r} "
              f"min_ms={min(ts)!r} max_ms={max(ts)!r} kernel={sched.last_kernel}")
        print(f"    last_phases_ms={json.dumps({k: v * 1e3 for k, v in sorted(sched.last_phases.items())})}")
        pools, inv, pods = specs[name]
        cpu = TorchScheduler(pools, inv, device="cpu").solve(pods)
        if canonical(cpu) != canonical(result):
            fail(f"{name}: the card's solve differs from the CPU plain solve")
        print(f"    equals the CPU plain-version solve ({len(cpu.new_nodes)} nodes)")
        prof = profile_solve(torch, sched, pods)
        print(f"    profiled solve (torch.profiler, {card}): "
              + (json.dumps(prof) if prof else "not measured: no device time seen"))

    kernels = []
    for k in ("choose_config", "ffd_scan"):
        dev_ms, _, plain = times["config2"][k]
        kernels.append({
            "name": k,
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
            "latency_floor_ms": floor_ms if k == "ffd_scan" else None,
        })
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
