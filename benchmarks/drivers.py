"""The closed loops the traffic files name (``"driver"``), one a kind of
call the program serves.

Each driver makes its cell's inputs from the seed in `setup` (set-up),
drives the program through the window in `window`, and afterwards, with
the program's state freed, holds a seeded sample of the window's answers
to the plain reference in `check`.  ``end_to_end`` gives the metrics the
window's calls yield.

- ``solve_cold``: back-to-back provisioning solves over a ring of distinct
  pending batches, more than the compile cache holds;
- ``solve_warm``: one pending set carried from solve to solve, a seeded
  share unchanged (a hit), the others with a seeded number of pods
  replaced (a delta);
- ``whatif``: consolidation passes: one removal batch over the universe's
  singles, then rounds of the population search, each pass on the base
  cluster with a fresh seeded churn of bound pods;
- ``admit``: single pods through the admission fast path, the trust window
  renewed on the run's clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np

from benchmarks import harness as H
from benchmarks import inputs as I
from benchmarks import program as P
from benchmarks.reference import solve as R

CHECK_STREAM, CLUSTER_STREAM, TRAFFIC_STREAM = 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), stream])


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from the seed."""

    def __init__(self, k: int, gen: np.random.Generator):
        self.k, self.gen, self.seen, self.items = k, gen, 0, []

    def offer(self, make) -> None:
        """``make()`` builds the item only when it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self.gen.integers(self.seen))
        if j < self.k:
            self.items[j] = make()


def mismatches(got: tuple, want: tuple) -> int:
    """Entries in one canonical result and not in the other."""
    return sum(len(set(a) ^ set(b)) for a, b in zip(got, want))


class Driver:
    def __init__(self, cell: H.Cell, seed: int, device: str, trace: bool):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, trace
        self.config, self.traffic = cell.config, cell.traffic
        self.mix = self.config["pending"]
        self.gen = rng(seed, TRAFFIC_STREAM)
        self.bounds: Dict[str, dict] = {}

    def build(self) -> None:
        """The catalog, the pools and the live cluster, both sides' way."""
        t0 = time.perf_counter()
        cfg = self.config
        self.shapes = I.machine_shapes(**cfg["catalog"])
        self.nodes = I.live_cluster(cfg["cluster"], self.mix, self.shapes,
                                    rng(self.seed, CLUSTER_STREAM))
        self.pools = P.pools(cfg)
        self.inventory = P.inventory(cfg, self.shapes, self.pools)
        self.existing = P.cluster(self.nodes, self.shapes)
        self.cat = R.Catalog(self.shapes, cfg["pools"])
        self.build_s = time.perf_counter() - t0

    def scheduler(self):
        from karpenter_tpu_torch.scheduling.solver import TorchScheduler

        return TorchScheduler(self.pools, self.inventory, existing=self.existing,
                              device=self.device, objective=self.config["objective"])

    def free(self) -> None:
        self.sched = None
        self.existing = self.base_existing = None


class SolveCold(Driver):
    def setup(self) -> None:
        self.build()
        self.sched = self.scheduler()
        t = self.traffic
        self.raw = [I.config2_batch(self.mix, self.gen, f"b{r}") for r in range(t["ring"])]
        self.batches = [[P.pod(p) for p in raw] for raw in self.raw]
        for r in range(t["warmup"]):
            self.sched.solve(self.batches[r])
        self.next = t["warmup"]

    def window(self, win: H.Window) -> None:
        keep = Reservoir(self.traffic["checked"], rng(self.seed, CHECK_STREAM))
        while win.open():
            r = self.next % len(self.batches)
            self.next += 1
            with win.call("solve", len(self.batches[r])) as rec:
                res = self.sched.solve(self.batches[r])
            rec["phases"] = dict(self.sched.last_phases)
            with win.hold():
                keep.offer(lambda: (rec["index"], self.raw[r], res))
        self.kept = keep.items

    def check(self, control: bool) -> List[tuple]:
        answers = [(i, raw, P.canonical(res)) for i, raw, res in self.kept]
        self.kept = None
        live = R.Live(self.cat, self.nodes)
        live_ctl = R.Live(self.cat, R.nodes_without_memory(self.nodes)) if control else None
        bad = 0
        bound = H.load_module(H.BENCH / "roofline" / "ffd_scan.py")
        for i, raw, got in answers:
            want, prob, pk = R.solve(self.cat, raw, live)
            if control:
                got = R.solve(self.cat, R.without_memory(raw), live_ctl)[0]
            bad += mismatches(got, want)
            if self.trace:
                self.bounds.setdefault("ffd_scan", {})[i] = bound.bound_ms(prob, pk)
        return [("solve_mismatches", bad, 0), ("solves_checked", len(answers), None)]

    def end_to_end(self, win: H.Window) -> Dict[str, float]:
        calls = [c for c in win.calls if c["kind"] == "solve"]
        return {"solve_p95_ms": 1e3 * H.nearest_rank([c["s"] for c in calls], 0.95),
                "pods_per_s": sum(c["work"] for c in calls) / win.window_s}

    def attempted(self, win: H.Window) -> tuple:
        return len(win.calls), 0


class SolveWarm(SolveCold):
    def setup(self) -> None:
        self.build()
        self.sched = self.scheduler()
        t = self.traffic
        self.pending_raw = I.config2_batch(self.mix, self.gen, "w")
        self.pending = [P.pod(p) for p in self.pending_raw]
        self.step = 0
        self.sched.solve(self.pending)  # cold: compiles and seeds the resident state
        for _ in range(t["warmup"]):
            self.change(force=True)
            self.sched.solve(self.pending)
        self.sched.solve(self.pending)  # a hit

    def change(self, force: bool = False) -> None:
        """A seeded share of the steps leave the pending set as it is; in
        the others a seeded number of its pods leave it and as many new pods
        of the mix join its end, as pods arrive in a pending queue."""
        t = self.traffic
        self.step += 1
        if not force and self.gen.random() < t["hit_share"]:
            return
        lo, hi = t["replace"]
        k = min(int(self.gen.integers(lo, hi + 1)), len(self.pending_raw))
        gone = set(int(i) for i in self.gen.choice(len(self.pending_raw), size=k, replace=False))
        raw = [p for i, p in enumerate(self.pending_raw) if i not in gone]
        pods = [p for i, p in enumerate(self.pending) if i not in gone]
        for j in range(k):
            p = I.pending_pod(self.mix, int(self.gen.integers(self.mix["pods"])), f"w{self.step}-{j}")
            raw.append(p)
            pods.append(P.pod(p))
        self.pending_raw, self.pending = raw, pods

    def window(self, win: H.Window) -> None:
        keep = Reservoir(self.traffic["checked"], rng(self.seed, CHECK_STREAM))
        while win.open():
            with win.hold():
                self.change()
            with win.call("solve", len(self.pending)) as rec:
                res = self.sched.solve(self.pending)
            rec["phases"] = dict(self.sched.last_phases)
            raw = self.pending_raw
            with win.hold():
                keep.offer(lambda: (rec["index"], raw, res))
        self.kept = keep.items


class WhatIf(Driver):
    def setup(self) -> None:
        self.build()
        self.base_nodes, self.base_existing = self.nodes, self.existing
        self.sched = self.scheduler()
        self.passes = self.missing = 0
        self.one_pass(None)
        self.churn()

    def universe(self):
        from karpenter_tpu_torch.scheduling.solver import RemovalCandidate

        order = sorted(range(len(self.nodes)), key=lambda i: (len(self.nodes[i]["pods"]), i))
        order = order[: self.traffic["universe"]]
        return order, [RemovalCandidate(self.existing[i].name, tuple(self.existing[i].pods))
                       for i in order]

    def one_pass(self, win: Optional[H.Window]) -> dict:
        """One consolidation pass as the controller drives it: the removal
        batch over the singles, then the search's rounds."""
        from karpenter_tpu_torch.scheduling.popsearch import SearchPlan

        t = self.traffic
        order, cands = self.universe()
        timed = win.call if win is not None else (lambda kind, n: contextlib.nullcontext({}))
        answers = []
        with timed("removals", len(cands)) as rec:
            verdicts = self.sched.evaluate_removals([[c] for c in cands], cands)
        rec["phases"] = dict(self.sched.last_phases)
        self.missing += len(cands) - len(verdicts)
        answers += [((k,), v) for k, v in enumerate(verdicts)]
        by_name = {s["name"]: s for s in self.shapes}
        prices = [by_name[self.nodes[i]["type"]]["od_price"] for i in order]
        plan = SearchPlan(len(cands), prices, [False] * len(cands), t["population"], t["rounds"],
                          seed=(self.seed + self.passes) % (1 << 31))
        self.passes += 1
        while True:
            keys = plan.propose()
            if not keys:
                break
            masks = np.zeros((len(keys), len(cands)), bool)
            for r, key in enumerate(keys):
                masks[r, list(key)] = True
            with timed("population", len(keys)) as rec:
                got = self.sched.evaluate_population(masks, cands)
            rec["phases"] = dict(self.sched.last_phases)
            self.missing += len(keys) - len(got)
            plan.observe(keys, [(v.fits, v.replacement_price) for v in got])
            answers += list(zip(keys, got))
        return {"nodes": self.nodes, "order": order, "answers": answers}

    def churn(self) -> None:
        """The next pass's cluster: the base with a fresh seeded churn of
        bound pods, as many deleted as bound anew, so every pass meets a
        changed cluster of the same load."""
        t = self.traffic
        nodes = I.churned(self.mix, self.base_nodes, self.shapes, self.gen, t["churn"],
                          f"c{self.passes}-")
        by_name = {s["name"]: s for s in self.shapes}
        self.existing = [old if new is base else P.state_node(new, by_name[new["type"]])
                         for base, old, new in zip(self.base_nodes, self.base_existing, nodes)]
        self.nodes = nodes
        self.sched.update(self.pools, self.inventory, existing=self.existing)

    def window(self, win: H.Window) -> None:
        keep = Reservoir(self.traffic["checked_passes"], rng(self.seed, CHECK_STREAM))
        self.missing = 0
        while win.open():
            done = self.one_pass(win)
            with win.hold():
                keep.offer(lambda: done)
                self.churn()
        self.kept = keep.items

    def check(self, control: bool) -> List[tuple]:
        """A seeded sample of each kept pass's what-ifs against the
        reference.  A verdict the program refused to give (``needs_host``)
        is founded only where the reference's pack opened two new nodes or
        more, the one case the batched verdict leaves to the host.  The
        control solves each removal onto new nodes alone."""
        gen = rng(self.seed, CHECK_STREAM + 10)
        bad = unfounded = checked = 0
        for done in self.kept:
            live = R.Live(self.cat, done["nodes"])
            answers = done["answers"]
            k = min(self.traffic["checked_per_pass"], len(answers))
            for j in sorted(gen.choice(len(answers), size=k, replace=False)):
                key, v = answers[int(j)]
                removed = [done["order"][i] for i in key]
                fits, price, opened = R.whatif(self.cat, live, removed)
                checked += 1
                if control:
                    got = R.whatif(self.cat, live, removed, without_rest=True)[:2]
                    bad += got != (fits, price)
                elif v.needs_host:
                    unfounded += opened < 2
                else:
                    bad += (v.fits, v.replacement_price) != (fits, price)
        self.kept = None
        return [("verdict_mismatches", bad, 0), ("needs_host_unfounded", unfounded, 0),
                ("verdicts_missing", self.missing, 0), ("whatifs_checked", checked, None)]

    def end_to_end(self, win: H.Window) -> Dict[str, float]:
        return {"whatifs_per_s": sum(c["work"] for c in win.calls) / win.window_s}

    def attempted(self, win: H.Window) -> tuple:
        return sum(c["work"] for c in win.calls), 0


class Admit(Driver):
    def setup(self) -> None:
        from karpenter_tpu_torch.scheduling import fastpath

        self.fastpath = fastpath
        self.build()
        self.sched = self.scheduler()
        first = I.pending_pod(self.mix, 0, "seed-0")
        self.sched.solve([P.pod(first)])  # seeds the resident state
        for j in range(self.traffic["warmup"]):
            raw = I.pending_pod(self.mix, int(self.gen.integers(self.mix["pods"])), f"warm-{j}")
            fastpath.try_admit(self.sched, [P.pod(raw)])
        self.sched._resident.note_sync(self.sched)

    def window(self, win: H.Window) -> None:
        from karpenter_tpu_torch.utils.trace import phase_collect

        keep = Reservoir(self.traffic["checked"], rng(self.seed, CHECK_STREAM))
        renew, synced = self.traffic["renew_s"], time.perf_counter()
        try_admit, resident, sched = self.fastpath.try_admit, self.sched._resident, self.sched
        self.outcomes: Dict[str, int] = {}
        j = 0
        while win.open():
            with win.hold():
                raw = I.pending_pod(self.mix, int(self.gen.integers(self.mix["pods"])), f"a{j}")
                pod = P.pod(raw)
                j += 1
            phases: Dict[str, float] = {}
            with win.call("admit", 1) as rec:
                if time.perf_counter() - synced >= renew:
                    resident.note_sync(sched)
                    synced = time.perf_counter()
                if self.trace:
                    with phase_collect(phases):
                        res = try_admit(sched, [pod])
                else:
                    res = try_admit(sched, [pod])
            rec["phases"] = phases
            with win.hold():
                key = (res.outcome, res.reason or next(iter(res.placements.values()), ""))
                self.outcomes[res.outcome] = self.outcomes.get(res.outcome, 0) + 1
                keep.offer(lambda: (rec["index"], raw, key))
        self.kept = keep.items

    def check(self, control: bool) -> List[tuple]:
        """Nominations and the two answers the fast path gives itself
        (``needs_new_node``, ``unschedulable``) against the reference; other
        fallbacks hand the pod to the batched solve and are counted apart;
        a ``mismatch`` (the program's own check refuted its kernel) is
        wrong.  The control admits each pod with its nodeSelector dropped:
        on live nodes with room, memory seldom decides a first fit."""
        live = R.Live(self.cat, self.nodes)
        bound = H.load_module(H.BENCH / "roofline" / "admit_kernel.py")
        bad = handed = 0
        for i, raw, got in self.kept:
            want = R.admit(self.cat, raw, live)
            if control:
                got = R.admit(self.cat, dict(raw, selector={}), live)
            if got[0] == "fallback" and got[1] not in ("needs_new_node", "unschedulable"):
                handed += 1
                continue
            bad += got != want
            if self.trace:
                prob = R.Problem(self.cat, [raw], live)
                self.bounds.setdefault("admit_kernel", {})[i] = bound.bound_ms(prob)
        n = len(self.kept)
        self.kept = None
        return [("admit_mismatches", bad, 0), ("admits_checked", n, None),
                ("handed_to_solve", handed, None)]

    def end_to_end(self, win: H.Window) -> Dict[str, float]:
        return {"admit_p95_ms": 1e3 * H.nearest_rank([c["s"] for c in win.calls], 0.95)}

    def attempted(self, win: H.Window) -> tuple:
        return len(win.calls), self.outcomes.get("mismatch", 0)


DRIVERS = {"solve_cold": SolveCold, "solve_warm": SolveWarm, "whatif": WhatIf, "admit": Admit}
