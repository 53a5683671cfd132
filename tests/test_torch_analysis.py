"""The port's static-analysis plane held to the JAX package's unit tests.

The cases of ``tests/test_analysis.py`` run on the port
(`torch_ported.port_tests`): the engine's findings, fingerprints and JSON
report, the call graph's resolution, the lock model and both lock rules,
the determinism analyzer (a moved root is a finding), the runtime rules'
teeth and the load harness's coverage.

Left out, each with the port case that takes its place:

- ``TestTracerDiscovery`` (2 cases): ``jax.jit`` discovery and traced
  bodies.  The port's ``tracer-safety`` discovers launch wrappers of the
  CUDA library instead (``analysis/tracer.py``): `TestLaunchWrapperDiscovery`
  forges each form (a module-level function, a method, ``lib = _lib()``,
  a wrapper nested in a factory, the library module's composition, a
  dispatched entry that picks a wrapper, a host query) and holds discovery
  on the port's tree to every ``_lib()`` caller of ``ops/fused_packer.py``,
  and ``device-put`` to the port's upload sites.
- ``TestSeamRegressions`` (2 cases): they import ``jax.numpy`` and
  ``fetch_bundled`` (the tunnel's output bundling, left out of the port on
  purpose).  `TestSeamRegressionsOnThePort` holds the service's solo pack
  (``service/server.py``) to one dispatch through the port's seam, with
  its wire arrays counted as uploads, and a solve's pack to the same.
"""

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

globals().update(port_tests(
    "test_analysis.py",
    left_out=("TestTracerDiscovery", "TestSeamRegressions"),
))


def _forge(tmp_path, files: dict):
    from karpenter_tpu_torch.analysis import PackageSnapshot

    pkg = tmp_path / "forged"
    for rel, src in files.items():
        path = pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    return PackageSnapshot(pkg)


# every function of ops/fused_packer.py whose body calls the library for a
# launch (the host queries left out)
FUSED_PACKER_LAUNCHERS = {
    "choose_config", "_launch_resident", "_launch_cluster", "_launch_grid", "_launch_global",
    "fleet_pack", "_launch_window", "verdict_rows", "population_prologue",
    "admit", "_assemble_launch", "choose_config_shard", "ffd_shard_scan",
    "ffd_shard_cap", "ffd_shard_apply",
}
HOST_QUERIES = {"scan_concurrency", "verdict_shape", "_verdict_max_axes",
                "_verdict_scratch_bytes", "grid_clusters"}


class TestLaunchWrapperDiscovery:
    def test_every_form_is_discovered(self, tmp_path):
        from karpenter_tpu_torch.analysis.tracer import discover_wrappers

        snap = _forge(tmp_path, {
            "ops/lib.py": (
                "def _lib():\n"
                "    return None\n"
                "def launch(x):\n"
                "    return _lib().ffd_launch(x)\n"
                "def bound(x):\n"
                "    lib = _lib()\n"
                "    return lib.ffd_bound(x)\n"
                "def query(k):\n"
                "    return _lib().ffd_query(k)\n"
                "def entry(x):\n"
                "    return launch(bound(x))\n"
                "def helper(x):\n"
                "    return x + 1\n"
                "class K:\n"
                "    def go(self, x):\n"
                "        return _lib().ffd_go(x)\n"
                "def factory():\n"
                "    def inner(x):\n"
                "        return _lib().ffd_inner(x)\n"
                "    return inner\n"
            ),
            "ops/pick.py": (
                "from forged.obs.device import OBSERVATORY\n"
                "from forged.ops.lib import launch\n"
                "def picked(x):\n"
                "    return launch(x) if x else x\n"
                "def undispatched(x):\n"
                "    return launch(x)\n"
                "def run(x):\n"
                "    return OBSERVATORY.dispatch('picked', picked, x)\n"
            ),
        })
        found = discover_wrappers(snap, frozenset({"ffd_query"}))
        assert found.keys == {
            "forged/ops/lib.py:launch": "library",
            "forged/ops/lib.py:bound": "library",
            "forged/ops/lib.py:K.go": "library",
            "forged/ops/lib.py:entry": "module",
            "forged/ops/pick.py:picked": "dispatched",
        }
        assert found.nested_keys == {"forged/ops/lib.py:factory.inner"}
        # a host query's caller is a wrapper once the query is not exempt
        assert "forged/ops/lib.py:query" in discover_wrappers(snap).keys

    def test_nested_wrapper_is_fenced_in_its_factory(self, tmp_path):
        from karpenter_tpu_torch.analysis import run_rules

        snap = _forge(tmp_path, {
            "ops/lib.py": (
                "def _lib():\n"
                "    return None\n"
                "def factory(x):\n"
                "    def inner(y):\n"
                "        return _lib().ffd_inner(y)\n"
                "    return inner(x)\n"
            ),
        })
        live, _ = run_rules(snap, rule_names=["tracer-safety"],
                            allowlists={"tracer-safety": frozenset()})
        assert len(live) == 1 and "nested launch wrapper inner" in live[0].message
        clean, _ = run_rules(
            snap, rule_names=["tracer-safety"],
            allowlists={"tracer-safety": frozenset({("forged/ops/lib.py", "factory")})},
        )
        assert not clean

    def test_port_tree_wrappers(self):
        from karpenter_tpu_torch.analysis import PackageSnapshot
        from karpenter_tpu_torch.analysis.allowlists import ALLOWLISTS
        from karpenter_tpu_torch.analysis.tracer import discover_wrappers, library_calls

        snap = PackageSnapshot.load()
        exempt = frozenset(e for e in ALLOWLISTS["tracer-safety"] if isinstance(e, str))
        found = discover_wrappers(snap, exempt)
        rel = "karpenter_tpu_torch/ops/fused_packer.py"
        library = {k.split(":")[1] for k, why in found.keys.items() if why == "library"}
        assert library == FUSED_PACKER_LAUNCHERS
        # discovery is complete: every def of the module that calls the
        # library for a non-exempt entry is a wrapper
        import ast

        tree = snap.modules[rel].tree
        callers = {
            fn.name for fn in ast.walk(tree)
            if isinstance(fn, ast.FunctionDef)
            and any(e not in exempt for e, _ in library_calls(fn))
        }
        assert callers == FUSED_PACKER_LAUNCHERS
        assert not HOST_QUERIES & {k.split(":")[1] for k in found.keys}
        # the entry points the port dispatches are wrappers by composition
        for name in ("ffd_pack", "fleet_pack", "removal_verdicts", "population_verdicts",
                     "mesh_pack", "mesh_assemble_feasibility"):
            assert f"{rel}:{name}" in found.keys
        assert found.keys["karpenter_tpu_torch/ops/packer.py:admit_kernel"] == "dispatched"

    def test_port_tree_upload_sites(self):
        """``device-put`` finds the port's upload idioms: with its
        allowlist emptied it fires exactly at the sites the allowlist
        argues, the observatory's counted copy among them."""
        from karpenter_tpu_torch.analysis import PackageSnapshot, RULES
        from karpenter_tpu_torch.analysis.allowlists import ALLOWLISTS

        snap = PackageSnapshot.load()
        hits = RULES["device-put"]().check(snap, frozenset())
        sites = {(f.file, f.message.split(":")[0]) for f in hits}
        assert sites == set(ALLOWLISTS["device-put"])
        assert ("karpenter_tpu_torch/obs/device.py", "DeviceObservatory.put") in sites

    def test_upload_idioms(self, tmp_path):
        from karpenter_tpu_torch.analysis import run_rules

        snap = _forge(tmp_path, {
            "ops/x.py": (
                "import torch\n"
                "i32, f32 = torch.int32, torch.float32\n"
                "def up(a, dev, t):\n"
                "    torch.tensor(a, device=dev)\n"
                "    torch.from_numpy(a).to(dev)\n"
                "    t.to(device=dev, non_blocking=True)\n"
                "    t.cuda()\n"
                "    torch.empty(3, device=dev).copy_(t)\n"
                "def not_up(a, dev, t):\n"
                "    t.to(torch.int32)\n"
                "    t.to(i32)\n"
                "    t.to(f32)\n"
                "    t.to('cpu')\n"
                "    torch.as_tensor(a, device='cpu')\n"
                "    torch.zeros(3, device=dev)\n"
                "    t.cpu()\n"
            ),
        })
        live, _ = run_rules(snap, rule_names=["device-put"],
                            allowlists={"device-put": frozenset()})
        assert [f.line for f in live] == [4, 5, 6, 7, 8], [f.render() for f in live]
        assert all(f.message.startswith("up:") for f in live)


class TestDeviceFetchUnderALock:
    """``lock-blocking`` counts the port's device fetches as blocking: a
    ``.cpu()``, ``.item()``, ``.tolist()`` or ``torch.cuda.synchronize()``
    waits for the card's queued work, so under a lock it convoys every
    other thread (the solver service solves from many)."""

    SRC = (
        "import threading\n"
        "import torch\n"
        "class Solver:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def fetch(self, t):\n"
        "        with self._lock:\n"
        "            return t.cpu()\n"
        "    def count(self, t):\n"
        "        with self._lock:\n"
        "            return t.item()\n"
        "    def rows(self, t):\n"
        "        with self._lock:\n"
        "            return t.tolist()\n"
        "    def wait(self):\n"
        "        with self._lock:\n"
        "            torch.cuda.synchronize()\n"
        "    def _read(self, t):\n"
        "        return t.cpu()\n"
        "    def through_a_call(self, t):\n"
        "        with self._lock:\n"
        "            return self._read(t)\n"
        "    def outside(self, t):\n"
        "        with self._lock:\n"
        "            n = t.shape[0]\n"
        "        return t.cpu(), n\n"
    )

    def test_fetch_under_a_lock_fires(self, tmp_path):
        from karpenter_tpu_torch.analysis import run_rules

        snap = _forge(tmp_path, {"ops/x.py": self.SRC})
        live, _ = run_rules(snap, rule_names=["lock-blocking"],
                            allowlists={"lock-blocking": frozenset()})
        quals = sorted(f.message.split(":")[0] for f in live)
        assert quals == ["Solver.count", "Solver.fetch", "Solver.rows",
                         "Solver.through_a_call", "Solver.wait"], [f.render() for f in live]
        ops = {f.message.split(":")[0]: f.message.split(" ")[1] for f in live}
        assert ops["Solver.wait"].startswith("synchronize(")
        allowed, _ = run_rules(snap, rule_names=["lock-blocking"], allowlists={
            "lock-blocking": frozenset({("forged/ops/x.py", "Solver.fetch")})})
        assert len(allowed) == len(live) - 1

    def test_port_tree_holds_no_fetch_under_a_lock(self):
        from karpenter_tpu_torch.analysis import PackageSnapshot, run_rules
        from karpenter_tpu_torch.analysis.locks import BLOCKING_CALLS

        assert {"cpu", "item", "tolist", "synchronize"} <= set(BLOCKING_CALLS)
        live, _ = run_rules(PackageSnapshot.load(), rule_names=["lock-blocking"])
        assert not live, [f.render() for f in live]


@pytest.mark.usefixtures("on_the_cpu")
class TestSeamRegressionsOnThePort:
    """The port's dispatch seam counts the launches of its two pack
    entry points: the solver service's solo pack and a solve."""

    @pytest.fixture(autouse=True)
    def _observing(self, monkeypatch):
        from karpenter_tpu_torch.obs.device import OBSERVATORY

        monkeypatch.setattr(OBSERVATORY, "enabled", True)

    def test_sidecar_pack_counts_through_the_seam(self):
        from karpenter_tpu_torch.api import Pod, Resources
        from karpenter_tpu_torch.obs.device import OBSERVATORY
        from karpenter_tpu_torch.ops.tensorize import compile_problem
        from karpenter_tpu_torch.service import RemoteSolver, SolverServer
        from karpenter_tpu_torch.testing import Environment

        env = Environment()
        pool = env.default_node_pool()
        env.default_node_class()
        types = env.instance_types.list(pool, env.kube.get_node_class("default"))
        pods = [Pod(requests=Resources(cpu=1, memory="1Gi")) for _ in range(8)]
        prob = compile_problem(pods, [pool], {pool.name: types})
        srv = SolverServer(port=0).start_background()
        scope = OBSERVATORY.begin_scope()
        try:
            client = RemoteSolver(*srv.address)
            client.pack_problem(prob)
            client.close()
        finally:
            OBSERVATORY.end_scope(scope)
            srv.stop()
        # the sidecar's pack lands in ITS process observatory (this one),
        # one dispatch, the wire arrays counted as its uploads
        assert scope.dispatches.get("ffd_pack") == 1
        assert scope.transfer_bytes.get("pack_kernel", 0) > 0

    def test_solve_counts_through_the_seam(self):
        import karpenter_tpu_torch
        from karpenter_tpu_torch import testing as T
        from karpenter_tpu_torch.obs.device import OBSERVATORY

        pools, inv, pods = T.heterogeneous_problem(scale=0.01)
        sched = karpenter_tpu_torch.TorchScheduler(pools, inv)
        scope = OBSERVATORY.begin_scope()
        try:
            sched.solve(pods)
        finally:
            OBSERVATORY.end_scope(scope)
        assert sched.last_path == "tensor"
        assert scope.dispatches.get("ffd_pack", 0) >= 1
        assert sum(scope.transfer_bytes.values()) > 0
