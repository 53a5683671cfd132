"""The port imports nothing of JAX and nothing of the JAX package.

A subprocess installs a meta-path finder that refuses ``jax``, ``jaxlib``
and ``karpenter_tpu`` / ``karpenter_tpu.*`` (but not ``karpenter_tpu_torch``),
then imports the port (the resident tensors' module and the population
search too) and ``chip_smoke`` and runs a small CPU cold solve, a
compile-cache hit, a one-pod delta, a removal batch and a population
round; then imports the operator and ``python -m karpenter_tpu_torch``'s
module and runs three ticks of a CPU operator `Environment`, then the
admission fast path (``scheduling/fastpath.py``) and the interruption,
metrics-state and consistency controllers: a single-pod arrival nominated
by the fast path, and a spot-interruption message drained; then the
disruption controller (``controllers/disruption.py``) consolidating a small
cluster through the operator under the pipelined schedule."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r'''
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

import chip_smoke  # noqa: F401
import karpenter_tpu_torch
from karpenter_tpu_torch import testing as T
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
import numpy as np

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
# the operator and the entry point: three ticks of a CPU environment
import karpenter_tpu_torch.__main__  # noqa: F401
from karpenter_tpu_torch.api import Pod, Resources
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
from karpenter_tpu_torch.api import Settings
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
# the disruption controller: consolidation through the operator, with the
# pipelined schedule's speculative stages
from karpenter_tpu_torch.controllers import DisruptionController  # noqa: F401

env = T.consolidating_cluster("cpu", n_pods=400)
assert isinstance(env.operator.disruption, DisruptionController)
for _ in range(6):
    env.step(2.0)
assert sum(env.registry.counters.get("karpenter_deprovisioning_actions", {}).values()) >= 1
assert env.registry.counters.get("karpenter_pipeline_speculation_total")
leaked = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("ok", len(result.new_nodes))
'''


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok ")
