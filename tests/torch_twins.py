"""Twin drives for the consolidation tests: one seeded scenario through the
JAX package's operator (on the CPU, as tier-1 runs it) and through the
port's (``device="cpu"``), read back as plain data for an equality check.

`Twin` holds one package's modules under the same names, so a scenario is
written once and run for each package.  Both sides launch one NodeClaim at
a time (`Twin.env`): concurrent launches hand out instance ids in thread
order, which would make the two cloud call streams differ in ids only.
`state` is `testing.operator_state` with the sequence numbers and the JAX
package's anomaly-detector and SLO-engine events dropped (they judge
wall-clock time, and its diagnosis layer is not ported: ROADMAP A3c), as
the operator twin reads it.
"""

import importlib
import random

PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")
PORT = "karpenter_tpu_torch"
FILTERED_EVENTS = ("AnomalyDetected", "DeviceRecompile", "SLOBreach", "SLORecovered")

# the reference consolidation tests' pod sizes
SIZES = ((0.5, "1Gi"), (1, "2Gi"), (2, "4Gi"))


class Twin:
    """One package's modules and its operator environments."""

    def __init__(self, pkg: str):
        self.pkg = pkg

        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")

        self.api = mod("api")
        self.objects = mod("api.objects")
        self.labels = mod("api.labels")
        self.requirements = mod("api.requirements")
        self.testing = mod("testing")
        self.backend = mod("cloud.fake.backend")
        self.disruption = mod("controllers.disruption")
        self.solver = mod("scheduling.solver")
        self.popsearch = mod("scheduling.popsearch")
        self.kube = mod("state.kube")

    def env(self, shapes=None, settings=None):
        """An operator `Environment` (the port's on the CPU) launching one
        claim at a time."""
        kw = {"device": "cpu"} if self.pkg == PORT else {}
        env = self.testing.Environment(shapes=shapes, settings=settings, **kw)
        env.operator.provisioner.launch_concurrency = 1
        return env

    def catalog(self, **kw):
        return self.backend.generate_catalog(**kw)

    def resources(self, cpu, mem):
        return self.api.Resources(cpu=cpu, memory=mem)

    def build_env(self, seed: int, npods: int, cpus=(4, 8), **settings_kw):
        """The reference tests' ``_build_env``: a WhenUnderutilized pool over
        the two-generation catalog of ``cpus``, ``npods`` seeded pods of the
        three sizes, settled until every pod is bound."""
        a = self.api
        self.objects.reset_name_sequences()
        settings = a.Settings(**settings_kw) if settings_kw else None
        env = self.env(self.catalog(generations=(1, 2), cpus=cpus), settings)
        env.default_node_class()
        env.default_node_pool(
            disruption=a.Disruption(consolidation_policy="WhenUnderutilized")
        )
        rng = random.Random(seed)
        for _ in range(npods):
            env.kube.put_pod(a.Pod(requests=self.resources(*rng.choice(SIZES))))
        env.settle(max_rounds=60)
        assert not env.kube.pending_pods(), self.pkg
        return env


def twins():
    return [Twin(pkg) for pkg in PACKAGES]


def ranked_candidates(dc):
    """The reference tests' ``_ranked_candidates``."""
    dc._budgets = dc._remaining_budgets()
    return sorted(
        (c for c in dc._candidates() if dc._consolidatable(c)),
        key=lambda c: c.disruption_cost(),
    )


def state(env) -> dict:
    """`operator_state` without sequence numbers and diagnosis events."""
    from karpenter_tpu_torch.testing import operator_state

    st = operator_state(env)
    st["events"] = [ev[1:] for ev in st["events"] if ev[2] not in FILTERED_EVENTS]
    st["event_counts"] = {
        k: v for k, v in st["event_counts"].items() if k not in FILTERED_EVENTS
    }
    return st


def tick_digest(env, dc) -> tuple:
    """The reference tests' per-tick decision digest: the claims marked for
    deletion, the in-flight replacements, every pod's binding."""
    return (
        tuple(sorted(
            name for name, cl in env.kube.node_claims.items()
            if cl.deleted_at is not None
        )),
        tuple(sorted(dc._pending)),
        tuple(sorted((p.key(), p.node_name or "") for p in env.kube.pods.values())),
    )


def counter_by_path(env) -> dict:
    evals = env.registry.counters.get("karpenter_consolidation_evals_total", {})
    return {k[0][1]: v for k, v in evals.items() if k}


def fx(x: float) -> str:
    """A float by its bits (``float.hex``), so equal means bit-equal."""
    return float(x).hex()


def assert_equal_states(ref: list, port: list) -> None:
    """Two drives' per-tick readings, tick for tick and key for key."""
    assert len(ref) == len(port), (len(ref), len(port))
    for tick, (a, b) in enumerate(zip(ref, port)):
        if isinstance(a, dict):
            for key in a:
                assert a[key] == b[key], (tick, key, a[key], b[key])
        else:
            assert a == b, (tick, a, b)
