"""Simulator runs of both packages, and the rule their traces are held to.

`run` drives one scenario through a package's `run_scenario` (the port's
on the CPU) with a `TraceWriter`.

`assert_twin_traces` is the cross-package rule.  Every ``meta``, ``tick``,
``ev``, ``api``, ``led`` and ``dig`` line must be byte-equal, and so must
the ``report`` line with its ``device`` section set aside.  The device
sections are held as the operator twin holds the observatory
(`tests/test_torch_operator.py`): the transfer sites and the
``resident_seed`` and ``pack_constants`` bytes equal, the resident updates
by kind equal, and the launches equal function for function under
`DISPATCH_NAMES` (the JAX package's two pack entry points are the port's
one ``ffd_pack``).  What differs by design is left out: the other sites'
bytes (the port uploads a delta's payload as three packed arrays and a
cold pack's arguments one by one), the resident bytes (the port's buffers
and padding are its own), the new signatures (a jit cache keys its
compiles otherwise than the port's launch signatures), and the JAX
package's ``bundle_outputs`` (its tunnel's output bitcast, which the port
leaves out).
"""

import importlib
import json

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")
PORT = "karpenter_tpu_torch"
# the JAX package's dispatch names -> the port's
DISPATCH_NAMES = {
    "pack_kernel": "ffd_pack",
    "pack_kernel_buffered": "ffd_pack",
    "removal_verdict_kernel": "removal_verdicts",
    "population_verdict_kernel": "population_verdicts",
    "resident_delta": "resident_delta",
    "admit_kernel": "admit_kernel",
    "fleet_pack_kernel": "fleet_pack",
}
JAX_ONLY_DISPATCHES = ("bundle_outputs",)


def run(pkg: str, name: str, seed: int, ticks: int):
    """(trace text, report, runner) of one run; the port's on the CPU."""
    runner_mod = importlib.import_module(f"{pkg}.sim.runner")
    trace_mod = importlib.import_module(f"{pkg}.sim.trace")
    writer = trace_mod.TraceWriter()
    kw = {"device": "cpu"} if pkg == PORT else {}
    runner, report = runner_mod.run_scenario(name, seed, ticks, trace=writer, **kw)
    return writer.text(), report, runner


def device_view(dev: dict, ref: bool) -> dict:
    """A report's device section as the twins compare it."""
    names = DISPATCH_NAMES if ref else {v: v for v in DISPATCH_NAMES.values()}

    dispatches = {}
    for k, v in dev["dispatches"].items():
        if k not in JAX_ONLY_DISPATCHES:
            dispatches[names[k]] = dispatches.get(names[k], 0) + v
    return {
        "dispatches": dispatches,
        "transfer_sites": sorted(dev["transfer_bytes"]),
        "resident_seed": dev["transfer_bytes"].get("resident_seed", 0),
        "pack_constants": dev["transfer_bytes"].get("pack_constants", 0),
        "resident_updates": dev["resident"]["updates"],
    }


def assert_twin_traces(ref_text: str, port_text: str) -> None:
    ref, port = ref_text.splitlines(), port_text.splitlines()
    assert len(ref) == len(port), (len(ref), len(port))
    for i, (a, b) in enumerate(zip(ref, port)):
        if json.loads(a)["t"] != "report":
            assert a == b, (i, a, b)
            continue
        ra, rb = json.loads(a)["slo"], json.loads(b)["slo"]
        da, db = ra.pop("device"), rb.pop("device")
        assert ra == rb, i
        assert device_view(da, True) == device_view(db, False), (da, db)
