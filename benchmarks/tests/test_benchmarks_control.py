"""The check of each cell, driven through the rest of a run on the CPU at
a size a test run holds (the look for a card skipped): sound runs come out
correct; the control (the reference with one of the configuration's
guarantees broken, in the program's place) comes out not correct; and so
does every fault the cell can have, planted in the program underneath the
timed path: a call that returns its state unchanged, half of the batch
left out, an answer altered where it is produced.  (No cell spans chips, so none can leave out
an exchange between them.)"""

from __future__ import annotations

import pytest

from benchmarks.tests import tiny

CELLS = ("live500-solve-cold", "live5k-whatif", "live500-admit", "live5k-solve-warm")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, cell):
    out = tiny.run(tmp_path, cell)
    assert out["correct"], out["checks"]
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tmp_path, cell):
    out = tiny.run(tmp_path, cell, control=1)
    assert not out["correct"], out["checks"]


def stale(orig):
    """The first answer, returned again on every later call."""
    first = []

    def call(self, *a, **kw):
        if not first:
            first.append(orig(self, *a, **kw))
        return first[0]
    return call


def solve_half(orig):
    def call(self, pods):
        pods = list(pods)
        return orig(self, pods[: len(pods) // 2])
    return call


def solve_altered(orig):
    """One pod of every result declared unschedulable where it was placed."""
    def call(self, pods):
        res = orig(self, pods)
        if res.existing_placements:
            key = next(iter(res.existing_placements))
            del res.existing_placements[key]
        else:
            vn = res.new_nodes[0]
            key = vn.pods.pop(0).key()
        res.unschedulable[key] = "altered"
        return res
    return call


def verdicts_half(orig):
    def call(self, first, universe):
        out = orig(self, first, universe)
        return out[: len(out) // 2]
    return call


def verdicts_altered(orig):
    """Every fourth verdict's answer turned round."""
    def call(self, first, universe):
        out = orig(self, first, universe)
        return [v._replace(fits=not v.fits, replacement_price=0.0) if i % 4 == 0 else v
                for i, v in enumerate(out)]
    return call


def admit_altered(orig):
    """A nomination sent to a node other than the one the score picked."""
    def call(sched, pods):
        res = orig(sched, pods)
        if res.outcome == "nominated":
            names = [sn.name for sn in sched.existing]
            res.placements = {k: names[(names.index(v) + 1) % len(names)]
                              for k, v in res.placements.items()}
        return res
    return call


def admit_stale(orig):
    first = []

    def call(sched, pods):
        if not first:
            first.append(orig(sched, pods))
        return first[0]
    return call


SOLVE = "karpenter_tpu_torch.scheduling.solver.TorchScheduler"
FAULTS = [
    ("live500-solve-cold", "unchanged", {f"{SOLVE}.solve": stale}),
    ("live500-solve-cold", "half", {f"{SOLVE}.solve": solve_half}),
    ("live500-solve-cold", "altered", {f"{SOLVE}.solve": solve_altered}),
    ("live5k-solve-warm", "unchanged", {f"{SOLVE}.solve": stale}),
    ("live5k-solve-warm", "half", {f"{SOLVE}.solve": solve_half}),
    ("live5k-solve-warm", "altered", {f"{SOLVE}.solve": solve_altered}),
    ("live5k-whatif", "unchanged", {f"{SOLVE}.evaluate_removals": stale,
                                     f"{SOLVE}.evaluate_population": stale}),
    ("live5k-whatif", "half", {f"{SOLVE}.evaluate_removals": verdicts_half,
                                f"{SOLVE}.evaluate_population": verdicts_half}),
    ("live5k-whatif", "altered", {f"{SOLVE}.evaluate_removals": verdicts_altered,
                                   f"{SOLVE}.evaluate_population": verdicts_altered}),
    ("live500-admit", "unchanged",
     {"karpenter_tpu_torch.scheduling.fastpath.try_admit": admit_stale}),
    ("live500-admit", "altered",
     {"karpenter_tpu_torch.scheduling.fastpath.try_admit": admit_altered}),
]


@pytest.mark.parametrize("cell,fault,patches", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault, patches):
    import importlib

    for target, make in patches.items():
        mod_name, _, attr = target.rpartition(".")
        try:
            owner = importlib.import_module(mod_name)
        except ModuleNotFoundError:
            pkg, _, cls = mod_name.rpartition(".")
            owner = getattr(importlib.import_module(pkg), cls)
        monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = tiny.run(tmp_path, cell)
    assert not out["correct"], out["checks"]
