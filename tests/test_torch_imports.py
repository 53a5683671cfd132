"""The port imports nothing of JAX and nothing of the JAX package.

Each stage runs in a subprocess of its own that installs a meta-path
finder refusing ``jax``, ``jaxlib`` and ``karpenter_tpu`` /
``karpenter_tpu.*`` (but not ``karpenter_tpu_torch``), keeps PyTorch to one
intra-op thread (as ``tests/torch_ported.py`` does for the in-process
tests: the suite runs in several workers at once), drives one part of the
port on the CPU, and ends by checking that no blocked module reached
``sys.modules``:

- ``solve``: the package, the resident tensors' module, the population
  search and ``chip_smoke`` imported; a cold solve, a compile-cache hit, a
  one-pod delta, a removal batch and a population round;
- ``operator``: the operator and ``python -m karpenter_tpu_torch``'s
  module; three ticks of a CPU `Environment`, then the admission fast path
  (``scheduling/fastpath.py``) and the interruption, metrics-state and
  consistency controllers: a single-pod arrival nominated by the fast
  path, and a spot-interruption message drained;
- ``disruption``: the disruption controller (``controllers/disruption.py``)
  consolidating a small cluster through the operator under the pipelined
  schedule;
- ``sim``: the diagnosis layer, the simulator and the load harness (every
  module of ``obs/``, ``state/wire.py``, ``sim/`` and ``load/``): a short
  ``steady`` run through the ``sim`` subcommand with its trace replayed, an
  operator with ``flight_dir`` whose flight dump goes through the
  ``doctor`` and ``obs`` subcommands; ``testing.py``'s drive functions of
  ``bench.py``'s three device lines (the admission fast path, the
  pipelined tick, the load harness) at a tiny size;
- ``service``: the solver service (``service/``, ``state/binwire.py``): a
  multi-tenant ``SolverServer(device="cpu")`` whose tenants solve through
  ``RemoteSolver`` (a fleet pack of two tenants forced through
  ``_run_batch``) and a ``TorchScheduler(pack_fn=...)`` packing through it;
- ``ha``: the shared cluster store, leader election and the lock sanitizer
  (``analysis/``, ``service/store_server.py``, ``service/shardrouter.py``,
  ``service/watchclient.py``, ``state/remote.py``, ``state/storelog.py``,
  ``sim/faults.py``, ``utils/leader.py``): two replicas of
  `testing.HAHarness` failing over on one store server, and a sanitized
  lock witness;
- ``fleet``: the fleet simulator (``sim/fleet.py``): a short
  ``solver-fleet`` run through the ``sim`` subcommand with its trace
  replayed, and the device profiler (``utils/trace.py``'s `device_trace`)
  writing a timeline;
- ``lint``: the static analysis (the rule engine and every rule module of
  ``analysis/``) through the ``lint`` subcommand, clean over the port's
  tree with 18 rules (its ``import-clean`` rule imports every module of
  the port under the finder); ``tools/`` (the chart rendered, the CRDs and
  the metrics page regenerated equal to the checked-in files, a kompat
  matrix, allocatable-diff over a CPU operator) and ``api/legacy.py``
  (a converted Provisioner and AWSNodeTemplate provisioning pods);
- ``parallel``: the device mesh (``parallel/``): a (4, 2) mesh of CPU
  shards; the sharded step on the mesh tests' problem equal to the
  unsharded plain pack; a `TorchScheduler` with the mesh's pack_fn solving
  cold, then a one-pod delta on its sharded resident state, equal to the
  single-device solve; the admission fast path falling back with
  ``sharded_backend``.

The stages were one script until it outgrew its time limit under the
suite's parallel load; each now has a limit of its own."""

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

PRELUDE = r'''
import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "karpenter_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Refuse())
try:
    import karpenter_tpu  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("the finder let karpenter_tpu through")

import torch

torch.set_num_threads(1)

import contextlib
import io
import os
import tempfile

import numpy as np

import karpenter_tpu_torch
from karpenter_tpu_torch import testing as T
from karpenter_tpu_torch.api import Pod, Resources, Settings

tmp = tempfile.mkdtemp()
out = io.StringIO()
'''

EPILOGUE = r'''
leaked = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("ok")
'''

STAGES = {
    "solve": r'''
import chip_smoke  # noqa: F401
from karpenter_tpu_torch.ops import _build, fused_packer, resident  # noqa: F401
from karpenter_tpu_torch.scheduling.popsearch import SearchPlan

pools, inv, pods = T.heterogeneous_problem(scale=0.01)
sched = karpenter_tpu_torch.TorchScheduler(pools, inv, device="cpu")
result = sched.solve(pods)
assert sched.last_path == "tensor", sched.last_path
assert not result.unschedulable
assert sum(len(n.pods) for n in result.new_nodes) == len(pods)
# the warm tick: a compile-cache hit, then a one-pod delta
sched.solve(pods)
assert sched.compile_cache_hits == 1 and sched.last_resident
pods = pods + [type(pods[0])(requests=pods[0].requests)]  # one arrival
result = sched.solve(pods)
assert sched.last_resident and sched.last_delta_rows > 0, sched.last_delta_rows
assert sum(len(n.pods) for n in result.new_nodes) == len(pods)
# the consolidation verdicts: a removal batch and a population round
pools, inv, existing, cands = T.consolidation_sweep(pods=60)
sched = karpenter_tpu_torch.TorchScheduler(pools, inv, existing=existing, device="cpu")
verdicts = sched.evaluate_removals([[c] for c in cands], cands)
assert len(verdicts) == len(cands) and sched.last_removal_batch == len(cands)
plan = SearchPlan(len(cands), T.node_prices(existing, inv), [False] * len(cands), 8, 1, 0)
keys = plan.propose()
masks = np.zeros((len(keys), len(cands)), bool)
for r, k in enumerate(keys):
    masks[r, list(k)] = True
plan.observe(keys, [(v.fits, v.replacement_price) for v in sched.evaluate_population(masks, cands)])
assert sched.last_removal_batch == len(keys)
''',
    "operator": r'''
import karpenter_tpu_torch.__main__  # noqa: F401
from karpenter_tpu_torch.operator import Operator  # noqa: F401

env = T.Environment(device="cpu")
env.default_node_class()
env.default_node_pool()
for _ in range(12):
    env.kube.put_pod(Pod(requests=Resources(cpu=0.5, memory="1Gi")))
for _ in range(3):
    env.step(2.0)
assert not env.kube.pending_pods() and env.kube.node_claims
assert env.operator.provisioner.scheduler.last_kernel == "reference"
# the admission fast path and the controllers copied with it
from karpenter_tpu_torch.controllers import (  # noqa: F401
    ConsistencyController, InterruptionController, MetricsStateController)
from karpenter_tpu_torch.scheduling import fastpath  # noqa: F401

env = T.Environment(settings=Settings(cluster_name="test", interruption_queue_name="q"),
                    device="cpu")
env.default_node_class()
env.default_node_pool()
for _ in range(12):
    env.kube.put_pod(Pod(requests=Resources(cpu=1.5, memory="1Gi")))
env.settle()
for _ in range(3):  # the first arrival after the batch is a resident miss
    env.kube.put_pod(Pod(requests=Resources(cpu=0.25, memory="512Mi")))
    env.step(2.0)
assert env.registry.counter("karpenter_admission_fastpath_total", {"outcome": "nominated"}) >= 1
claim = next(iter(env.kube.node_claims.values()))
env.cloud.send_message({"kind": "spot_interruption", "instance_id": claim.provider_id})
env.step(2.0)  # receive + drain + terminate
env.settle()
assert claim.name not in env.kube.node_claims and not env.kube.pending_pods()
names = [spec.name for spec in env.operator.pipeline.specs]
assert names[-2:] == ["metrics_state", "consistency"] and "interruption" in names, names
''',
    "disruption": r'''
from karpenter_tpu_torch.controllers import DisruptionController  # noqa: F401

env = T.consolidating_cluster("cpu", n_pods=400)
assert isinstance(env.operator.disruption, DisruptionController)
for _ in range(6):
    env.step(2.0)
assert sum(env.registry.counters.get("karpenter_deprovisioning_actions", {}).values()) >= 1
assert env.registry.counters.get("karpenter_pipeline_speculation_total")
''',
    "sim": r'''
from karpenter_tpu_torch.__main__ import main as entry
from karpenter_tpu_torch.load import corpus, generators, invariants, sketch  # noqa: F401
from karpenter_tpu_torch.obs import detect, doctor, flight, http, render, slo  # noqa: F401
from karpenter_tpu_torch.sim import cli, report, runner, trace, workload  # noqa: F401
from karpenter_tpu_torch.sim import invariants as sim_invariants  # noqa: F401
from karpenter_tpu_torch.state import wire  # noqa: F401

path = os.path.join(tmp, "steady.jsonl")
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
    assert entry(["sim", "--scenario", "steady", "--seed", "2", "--ticks", "6",
                  "--device", "cpu", "--trace", path]) == 0
    assert entry(["sim", "--replay", path, "--device", "cpu"]) == 0
env = T.Environment(settings=Settings(cluster_name="test", flight_dir=tmp), device="cpu")
env.default_node_class()
env.default_node_pool()
env.kube.put_pod(Pod(requests=Resources(cpu=0.5, memory="1Gi")))
for _ in range(3):
    env.step(2.0)
dump = env.operator.dump_flight("manual")
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
    assert entry(["doctor", dump]) == 0
    assert entry(["obs", dump]) == 0
assert "suspected causes" in out.getvalue()
adm = T.admission_drive("cpu", scale=0.01, iters=3)
assert adm["outcomes"] == {"nominated": 1 + T.ADMISSION_WARMUP + 6}, adm["outcomes"]
pipe = T.pipelined_tick_drive("cpu", True, ticks=3)
assert len(pipe["states"]) == 3
load = T.load_harness_drive("cpu", ticks=2)
assert load["events"] > 0 and load["violations"] == []
''',
    "service": r'''
from karpenter_tpu_torch.ops.packer import run_pack
from karpenter_tpu_torch.ops.tensorize import compile_problem
from karpenter_tpu_torch.service import RemoteSolver, SolverServer
from karpenter_tpu_torch.service.server import PACK_ARG_ORDER, _Pending
from karpenter_tpu_torch.ops.packer import pad_problem
from karpenter_tpu_torch.state import binwire  # noqa: F401

env = T.Environment(device="cpu")
pool = env.default_node_pool()
env.default_node_class()
types = env.instance_types.list(pool, env.kube.get_node_class("default"))
probs = [compile_problem([Pod(requests=Resources(cpu=c, memory="1Gi")) for _ in range(12)],
                         [pool], {pool.name: types}) for c in (0.5, 2)]
srv = SolverServer(port=0, multi_tenant=True, device="cpu").start_background()
try:
    pend = []
    for i, prob in enumerate(probs):
        args, kp = pad_problem(prob)
        pend.append(_Pending(f"t{i}", list(args), kp, "nodes"))
    srv._run_batch(pend)
    for p, prob in zip(pend, probs):
        take = p.future.result(timeout=60)[0]
        assert (take == run_pack(prob, device="cpu").take).all()
    c = RemoteSolver(*srv.address, tenant="t0")
    sched = karpenter_tpu_torch.TorchScheduler([pool], {pool.name: types}, device="cpu",
                                               pack_fn=c.pack_problem)
    result = sched.solve([Pod(requests=Resources(cpu=1, memory="1Gi")) for _ in range(30)])
    assert sched.last_kernel == "custom" and not sched.last_resident
    c.close()
finally:
    srv.stop()
''',
    "ha": r'''
from karpenter_tpu_torch.analysis import allowlists, core, sanitizer, witness  # noqa: F401
from karpenter_tpu_torch.service import shardrouter, store_server, watchclient  # noqa: F401
from karpenter_tpu_torch.sim import faults  # noqa: F401
from karpenter_tpu_torch.state import remote, storelog  # noqa: F401
from karpenter_tpu_torch.utils.leader import LeaderElector  # noqa: F401

h = T.HAHarness(device="cpu", settings=Settings(cluster_name="ha", enable_admission_fastpath=False))
try:
    h.default_node_class()
    h.node_pool("default")
    h.sync()
    marks = T.ha_drive(h, [Pod(requests=Resources(cpu=0.5, memory="1Gi")) for _ in range(40)],
                       churn_pods=4, churn_rounds=(1, 1, 1))
    T.ha_checks(h, marks)
finally:
    h.close()
san = sanitizer.enable("imports")
lock = sanitizer.make_lock("Imports._lock")
with lock:
    sanitizer.note_blocking("send_frame")
sanitizer.disable()
assert [f.rule for f in san.findings()] == ["rt-lock-blocking"]
''',
    "fleet": r'''
from karpenter_tpu_torch.__main__ import main as entry
from karpenter_tpu_torch.sim import fleet  # noqa: F401
from karpenter_tpu_torch.utils.trace import Tracer, device_trace

fleet_path = os.path.join(tmp, "fleet.jsonl")
with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
    assert entry(["sim", "--scenario", "solver-fleet", "--seed", "0", "--ticks", "8",
                  "--device", "cpu", "--trace", fleet_path]) == 0
    assert entry(["sim", "--replay", fleet_path, "--device", "cpu"]) == 0
prof = os.path.join(tmp, "prof")
with device_trace(Tracer(enabled=True, profile_dir=prof)):
    torch.ones(4).sum()
assert len(os.listdir(prof)) == 1
''',
    "lint": r'''
# the static analysis of the port's own tree through the entry point's
# lint subcommand (its import-clean rule imports every module of the
# port under this finder), then tools/ and api/legacy.py
import json
import pathlib

from karpenter_tpu_torch.__main__ import main as entry
from karpenter_tpu_torch.analysis import (  # noqa: F401
    cli, graph, locks, reachability, rules_legacy, settings_flow, tenant_metrics, tracer)
from karpenter_tpu_torch.api.legacy import convert_aws_node_template, convert_provisioner
from karpenter_tpu_torch.api.objects import Toleration
from karpenter_tpu_torch.tools import allocatable_diff, gen_crds, gen_metrics_doc, kompat
from karpenter_tpu_torch.tools.render_chart import render_chart

with contextlib.redirect_stdout(out):
    assert entry(["lint", "--json"]) == 0
report = json.loads(out.getvalue())
assert report["counts"]["findings"] == 0 and len(report["rules"]) == 18, report["counts"]
assert render_chart("deploy/chart", {"settings.cluster_name": "x"})
assert gen_crds.generate() == {p.name: p.read_text() for p in pathlib.Path("deploy/crds").glob("*.yaml")}
pkg = pathlib.Path(karpenter_tpu_torch.__path__[0])
assert gen_metrics_doc.render(pkg) == (pkg.parent / "docs" / "torch" / "metrics.md").read_text()
m = kompat.parse({"name": "k", "compatibility": [
    {"appVersion": "0.31.x", "minK8sVersion": "1.23", "maxK8sVersion": "1.28"}]})
assert m.compatible("0.31.4", "1.28")
env = T.Environment(device="cpu")
env.kube.put_node_class(convert_aws_node_template({
    "kind": "AWSNodeTemplate", "metadata": {"name": "default"},
    "spec": {"subnetSelector": {"Name": "*"}, "securityGroupSelector": {"Name": "*"}}}))
env.kube.put_node_pool(convert_provisioner({
    "kind": "Provisioner", "metadata": {"name": "default"},
    "spec": {"providerRef": {"name": "default"},
             "taints": [{"key": "dedicated", "value": "ml", "effect": "NoSchedule"}]}}))
for _ in range(4):
    env.kube.put_pod(Pod(requests=Resources(cpu=1, memory="1Gi"),
                         tolerations=[Toleration(key="dedicated", value="ml")]))
env.settle()
assert not env.kube.pending_pods() and env.kube.node_claims
rows = allocatable_diff.diff_rows(env.operator)
assert rows.rows and not rows.skipped and not allocatable_diff.overpromised(rows.rows)
''',
    "parallel": r'''
from karpenter_tpu_torch.ops import packer as P
from karpenter_tpu_torch.parallel import make_mesh, mesh_pack_fn, sharded_solve_step
from karpenter_tpu_torch.scheduling import fastpath

mesh = make_mesh(8, ["cpu"] * 8)
assert mesh.shape == (4, 2)
p = T.mesh_step_problem()
got = sharded_solve_step(mesh, 32)(*(p[k] for k in T.MESH_STEP_ARGS))
feas = P.assemble_feasibility_reference(
    *(torch.from_numpy(p[k]) for k in T.MESH_STEP_ARGS[:7]), 0, 16, 0, 64)
args = P.to_device(tuple(feas.numpy() if k == "feas" else p[k] for k in (
    "req", "cnt", "maxper", "slot", "feas", "alloc", "price", "openable",
    "used0", "cfg0", "npods0", "next0", "sig0")), torch.device("cpu"))
args = args[:11] + (int(args[11]),) + args[12:]
for a, b in zip(got, P.pack_reference(*args)):
    assert torch.equal(a, b)
pools, inv, pods = T.heterogeneous_problem(scale=0.01)
single = karpenter_tpu_torch.TorchScheduler(pools, inv, device="cpu")
sharded = karpenter_tpu_torch.TorchScheduler(pools, inv, device="cpu", pack_fn=mesh_pack_fn(mesh))
key = lambda r: sorted((len(n.pods), n.feasible_types[0].name) for n in r.new_nodes)
assert key(sharded.solve(pods)) == key(single.solve(pods))
assert sharded.last_kernel == "scan-sharded" and sharded._resident.states[-1].mesh is mesh
pods = pods + [type(pods[0])(requests=pods[0].requests)]  # one arrival
assert key(sharded.solve(pods)) == key(single.solve(pods))
assert sharded.last_resident and sharded.last_delta_rows > 0
few = pods[:4]  # a warm state a one-pod arrival can refresh
sharded.solve(few)
res = fastpath.try_admit(sharded, [type(pods[0])(requests=pods[0].requests)])
assert (res.outcome, res.reason) == ("fallback", fastpath.REASON_SHARDED_BACKEND), res
''',
}


@pytest.mark.parametrize("stage", list(STAGES))
def test_port_imports_without_jax(stage):
    proc = subprocess.run(
        [sys.executable, "-c", PRELUDE + STAGES[stage] + EPILOGUE],
        cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.endswith("ok\n"), proc.stdout
