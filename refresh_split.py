"""Where the admission fast path's resident refresh spends its time.

Drives the arrivals of chip_smoke.py's phase 8 through ONE package's
operator: config 2's catalog with the ``general`` and tainted ``dedicated``
pools, the first ``--pods`` of config 2's pods bound in a few ticks, then
one arrival a 2 s tick of fake clock (single pods of the shapes of pods
drawn with seed 11, bursts of 2-8 pods of one drawn shape each followed by
a quiet tick, pods past every live node's headroom), with the admission
fast path and the singleton bypass on.  Each fast-path attempt's resident
refresh (``ResidentCache.refresh`` inside ``try_admit``, the attempt's
``delta`` phase) is split on the host clock into:

- ``plan``: ``ResidentState._plan`` (the node diff and the pod diff);
- ``device``: the delta's uploads and its gather + scatter launch (the
  observatory's ``resident_delta`` seam);
- ``snapshot``: ``ResidentState._snapshot`` (the copies decode keeps);
- ``mirror``: the rest of ``ResidentState._apply`` (the class order, the
  host mirror edits, the bookkeeping);
- ``rest``: the refresh less all of these (the trust window and the loop
  over the cache's states).

Prints one JSON line: the attempts by outcome, and per part the p50 and
p99 in ms over the attempts whose refresh hit a state, with the count of
live nodes and of classes at the last such refresh.  ``--profile N``
also runs the fast-path attempts under cProfile and prints, before that
line, the N functions with the most cumulative time (the profiler slows
the attempts, so its times are shares, not readings).

    JAX_PLATFORMS=cpu python3 refresh_split.py --package karpenter_tpu
    python3 refresh_split.py --package karpenter_tpu_torch --device cpu
    python3 refresh_split.py --package karpenter_tpu_torch --device cuda

The JAX package runs where JAX puts it (the CPU with the variable above);
``--device`` is the port's solver device.

    JAX_PLATFORMS=cpu python3 refresh_split.py --twin

drives the same arrivals through both packages' operators on the CPU in
step and prints, as one JSON line, the first tick after which their
states differ (null where none did); it exits 1 on a difference.
"""

from __future__ import annotations

import argparse
import cProfile
import importlib
import json
import pstats
import random
import statistics
import sys
import time

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")
PARTS = ("refresh", "plan", "mirror", "device", "snapshot", "rest")
TICK_S = 2.0
ARRIVAL_SEED = 11
BURST_SIZES = (2, 8)
OVERSIZED_CPU = 100.0
CONFIG2_CATALOG = dict(
    generations=(1, 2, 3),
    cpus=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192),
)


class RefreshSplit:
    """Wraps one package's ``try_admit``, ``ResidentCache.refresh``,
    ``ResidentState._plan`` / ``_apply`` / ``_snapshot`` and its
    observatory's ``put`` / ``dispatch`` for the ``resident_delta`` site,
    and sums each part's host seconds per fast-path attempt."""

    def __init__(self, pkg: str, profile: bool = False):
        self.profile = cProfile.Profile() if profile else None
        self.fastpath = importlib.import_module(f"{pkg}.scheduling.fastpath")
        self.resident = importlib.import_module(f"{pkg}.ops.resident")
        self.obs = importlib.import_module(f"{pkg}.obs.device").OBSERVATORY
        self.attempts = []
        self._cur = None
        self._saved = []

    def _wrap(self, owner, name, part, when=None):
        orig = getattr(owner, name)
        self._saved.append((owner, name, owner.__dict__.get(name)))

        def timed(*args, **kwargs):
            cur = self._cur
            if cur is None or (when is not None and not when(args)):
                return orig(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                cur[part] = cur.get(part, 0.0) + (time.perf_counter() - t0) * 1e3

        setattr(owner, name, timed)

    def __enter__(self):
        fp, res, obs = self.fastpath, self.resident, self.obs
        orig_admit = fp.try_admit

        def admit(scheduler, pods):
            self._cur = cur = {}
            if self.profile is not None:
                self.profile.enable()
            try:
                out = orig_admit(scheduler, pods)
            finally:
                self._cur = None
                if self.profile is not None:
                    self.profile.disable()
            st = scheduler._resident.states[-1] if scheduler._resident.states else None
            self.attempts.append({
                "outcome": out.outcome, "reason": out.reason, "ms": cur,
                "live": len(st.live) if st is not None else 0,
                "classes": len(st.cls) if st is not None else 0,
            })
            return out

        self._saved.append((fp, "try_admit", orig_admit))
        fp.try_admit = admit
        self._wrap(res.ResidentCache, "refresh", "refresh")
        self._wrap(res.ResidentState, "_plan", "plan")
        self._wrap(res.ResidentState, "_apply", "apply")
        self._wrap(res.ResidentState, "_snapshot", "snapshot")
        delta = lambda args: args and args[0] == "resident_delta"
        self._wrap(obs, "put", "device", delta)
        self._wrap(obs, "dispatch", "device", delta)
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self._saved):
            if value is None or owner is self.obs:
                delattr(owner, name)
            else:
                setattr(owner, name, value)

    def hits(self) -> list:
        """The attempts whose refresh hit a state, each with its parts in
        ms, ``mirror`` and ``rest`` derived."""
        out = []
        for a in self.attempts:
            m = a["ms"]
            if "apply" in m:
                mirror = m["apply"] - m.get("snapshot", 0.0) - m.get("device", 0.0)
                out.append(dict(a, ms=dict(m, mirror=mirror,
                                           rest=m["refresh"] - m["plan"] - m["apply"])))
        return out

    def summary(self) -> dict:
        """Per part p50 / p99 ms over the attempts whose refresh hit."""
        hit = self.hits()
        rows = [a["ms"] for a in hit]
        out = {}
        for part in PARTS:
            v = sorted(r.get(part, 0.0) for r in rows)
            out[part] = ({"p50": statistics.median(v), "p99": v[min(len(v) - 1, int(0.99 * len(v)))]}
                         if v else None)
        outcomes = {}
        for a in self.attempts:
            key = a["outcome"] if a["outcome"] != "fallback" else f"fallback:{a['reason']}"
            outcomes[key] = outcomes.get(key, 0) + 1
        last = hit[-1] if hit else {"live": 0, "classes": 0}
        return {"attempts": outcomes, "refresh_hits": len(hit), "ms": out,
                "live_nodes": last["live"], "classes": last["classes"]}


def config2_pods(pkg: str, n: int) -> list:
    """Config 2's first ``n`` pending pods (the port's
    ``testing.heterogeneous_pods``) as ``pkg``'s pods."""
    a = importlib.import_module(f"{pkg}.api")
    L = importlib.import_module(f"{pkg}.api.labels")
    tol = a.Toleration(key="dedicated", value="batch", effect="NoSchedule")
    variants = [{}, {L.LABEL_ARCH: "amd64"}, {L.LABEL_INSTANCE_CATEGORY: "compute"},
                {L.LABEL_INSTANCE_CATEGORY: "memory"}]
    pods = []
    for i in range(n):
        cpu = 0.05 * (1 + i % 80)
        mem_gib = max(0.25, cpu * (1, 2, 4, 8)[(i // 80) % 4])
        req = a.Resources(cpu=round(cpu, 2), memory=f"{int(mem_gib * 1024)}Mi")
        if i % 10 < 7:
            pods.append(a.Pod(requests=req, node_selector=dict(variants[i % 10 % 4])))
        else:
            pods.append(a.Pod(requests=req, tolerations=[tol],
                              node_selector={L.LABEL_NODEPOOL: "dedicated"}))
    return pods


def environment(pkg: str, device: str):
    """``pkg``'s operator environment as chip_smoke.py's ``operator_env``
    builds it, with the fast path and the singleton bypass on: both
    packages run their disruption controller, the pools never consolidate
    and the drift gate is off."""
    a = importlib.import_module(f"{pkg}.api")
    objects = importlib.import_module(f"{pkg}.api.objects")
    testing = importlib.import_module(f"{pkg}.testing")
    backend = importlib.import_module(f"{pkg}.cloud.fake.backend")
    objects.reset_name_sequences()
    settings = a.Settings(cluster_name="chip-smoke", enable_admission_fastpath=True,
                          provision_fastpath_bypass=True, enable_pipelined_reconcile=False,
                          feature_gate_drift=False)
    kw = {"device": device} if pkg == "karpenter_tpu_torch" else {}
    env = testing.Environment(shapes=backend.generate_catalog(**CONFIG2_CATALOG),
                              settings=settings, **kw)
    env.default_node_class()
    hold = lambda: a.Disruption(consolidate_after=1e9)
    env.default_node_pool(name="general", disruption=hold())
    env.default_node_pool(name="dedicated", disruption=hold(),
                          taints=[a.Taint(key="dedicated", value="batch", effect="NoSchedule")])
    env.operator.provisioner.launch_concurrency = 1
    return env


def bind(env, pods, bind_ticks: int = 12):
    """Puts ``pods`` into the store and steps until every one is bound,
    yielding after each tick."""
    for p in pods:
        env.kube.put_pod(p)
    for _ in range(bind_ticks):
        env.step(TICK_S)
        yield
        if not env.kube.pending_pods():
            return
    raise SystemExit(f"{len(env.kube.pending_pods())} pods unbound")


def arrive(pkg: str, env, pods, arrivals: int, bursts: int, oversized: int):
    """Phase 8's arrivals, one a tick, yielding after each tick: single pods
    of the shapes of ``pods`` drawn with `ARRIVAL_SEED`, bursts of one drawn
    shape each followed by a quiet tick, then pods past every live node's
    headroom (sized when their tick comes)."""
    a = importlib.import_module(f"{pkg}.api")

    def shaped(name, tpl):
        return a.Pod(name=name, requests=tpl.requests, node_selector=dict(tpl.node_selector),
                     tolerations=list(tpl.tolerations))

    def headroom_cpu() -> float:
        used = {}
        for p in env.kube.pods.values():
            if p.node_name:
                used[p.node_name] = used.get(p.node_name, 0.0) + p.requests.cpu
        return max((n.allocatable.cpu - used.get(name, 0.0)
                    for name, n in env.kube.nodes.items()), default=0.0)

    rng = random.Random(ARRIVAL_SEED)
    plan = [[shaped(f"arrival-{i:03d}", rng.choice(pods))] for i in range(arrivals)]
    for b in range(bursts):
        tpl, n = rng.choice(pods), rng.randint(*BURST_SIZES)
        plan += [[shaped(f"burst-{b:02d}-{j}", tpl) for j in range(n)], []]
    plan += [None] * oversized
    for o, new in enumerate(plan):
        if new is None:
            cpu = max(OVERSIZED_CPU, float(int(headroom_cpu())) + 1.0)
            new = [a.Pod(name=f"oversized-{o}", requests=a.Resources(cpu=cpu, memory="4Gi"))]
        for p in new:
            env.kube.put_pod(p)
        env.step(TICK_S)
        yield


def drive(pkg: str, device: str, n_pods: int, arrivals: int, bursts: int, oversized: int,
          profile: bool = False):
    """The arrivals of phase 8 through ``pkg``'s operator; returns the
    `RefreshSplit` and the drive's facts (seconds, sizes)."""
    env = environment(pkg, device)
    pods = config2_pods(pkg, n_pods)
    t0 = time.perf_counter()
    for _ in bind(env, pods):
        pass
    bind_s = time.perf_counter() - t0
    print(f"{n_pods} pods bound in {bind_s:.1f} s", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    with RefreshSplit(pkg, profile) as split:
        for o, _ in enumerate(arrive(pkg, env, pods, arrivals, bursts, oversized)):
            print(f"tick {o + 1}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return split, dict(package=pkg,
                       device=device if pkg == "karpenter_tpu_torch" else "jax default",
                       pods=n_pods, bind_s=bind_s, arrivals_s=time.perf_counter() - t0)


def twin(n_pods: int, arrivals: int, bursts: int, oversized: int) -> dict:
    """The same drive through both packages' operators on the CPU, in step:
    after every tick the two ``testing.operator_state`` must agree.  The
    JAX package's diagnosis layer (not ported: ROADMAP A3c) judges wall
    clock and compile history, so its events are left out of the counts,
    and the event ledger is held by counts: its ring's window shifts where
    those events fall inside it.  Returns the ticks run and the first tick
    that differed, with its keys (None where none did)."""
    from karpenter_tpu_torch.testing import operator_state

    filtered = ("AnomalyDetected", "DeviceRecompile", "SLOBreach", "SLORecovered")
    envs = {pkg: environment(pkg, "cpu") for pkg in PACKAGES}

    def run(pkg):
        pods = config2_pods(pkg, n_pods)
        yield from bind(envs[pkg], pods)
        yield from arrive(pkg, envs[pkg], pods, arrivals, bursts, oversized)

    def state(env) -> dict:
        st = operator_state(env)
        del st["events"]
        st["event_counts"] = {k: v for k, v in st["event_counts"].items() if k not in filtered}
        return st

    tick = 0
    for tick, _ in enumerate(zip(*(run(pkg) for pkg in PACKAGES)), 1):
        ref, port = (state(envs[pkg]) for pkg in PACKAGES)
        differ = sorted(k for k in ref if ref[k] != port.get(k))
        if differ:
            return {"ticks": tick, "first_difference": {"tick": tick, "keys": differ}}
    return {"ticks": tick, "first_difference": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=PACKAGES)
    ap.add_argument("--twin", action="store_true",
                    help="drive both packages on the CPU in step and report where they differ")
    ap.add_argument("--device", default="cuda", help="the port's solver device")
    ap.add_argument("--pods", type=int, default=10_000)
    ap.add_argument("--arrivals", type=int, default=200)
    ap.add_argument("--bursts", type=int, default=10)
    ap.add_argument("--oversized", type=int, default=5)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="print the N functions of the attempts with the most cumulative time")
    args = ap.parse_args(argv)
    if args.twin:
        out = twin(args.pods, args.arrivals, args.bursts, args.oversized)
        print(json.dumps(out), flush=True)
        return 0 if out["first_difference"] is None else 1
    if args.package is None:
        ap.error("--package is required without --twin")
    split, facts = drive(args.package, args.device, args.pods, args.arrivals, args.bursts,
                         args.oversized, profile=args.profile > 0)
    if split.profile is not None:
        pstats.Stats(split.profile, stream=sys.stdout).sort_stats("cumulative").print_stats(
            args.profile)
    print(json.dumps(dict(split.summary(), **facts)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
