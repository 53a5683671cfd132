"""The port's solver service: the sidecar, the multi-tenant server, their
wire codec and the entry point's remote pack.

Every case of ``tests/test_service.py`` and of
``tests/test_service_tenants.py`` runs on the port
(`torch_ported.port_tests`) with the servers, schedulers and packs on the
CPU (the `on_the_cpu` fixture), the twin test too: tenants solving through
the shared server, the batched `fleet_pack` path forced by concurrent
peers, get placements bit-equal to a dedicated sidecar; and
``TestSolverFleet``, which drives ``sim/fleet.py``'s ``solver-fleet``
scenario, its module-scoped ``solver_fleet_run`` asked for the CPU by
`torch_ported.FLEET_ON_THE_CPU`'s replacements (a module fixture is
built before `on_the_cpu`).  The reference says ``TensorScheduler`` where
the port says ``TorchScheduler`` (`SCHEDULER`), and its module-scoped
``server`` fixture, which the port file defines again for the same reason,
serves on the CPU here.

Then the codec twin: `encode` of seeded arrays, and `encode_payload` /
`encode_value` of seeded store objects, give the same bytes in both
packages, and each decodes back to what went in.  And the entry point:
``python -m karpenter_tpu_torch --device cpu --solver-address ...``
against an in-process `SolverServer(device="cpu")` packs remotely
(``kernel`` ``custom``) and launches the same claims as the local run.
"""

import importlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from torch_ported import FLEET_ON_THE_CPU, on_the_cpu, port_tests  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ("karpenter_tpu", "karpenter_tpu_torch")
SCHEDULER = [("TensorScheduler", "TorchScheduler")]

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_service.py", text=SCHEDULER))
globals().update(port_tests("test_service_tenants.py",
                            text=FLEET_ON_THE_CPU["test_service_tenants.py"],
                            fixtures=("solver_fleet_run",)))


@pytest.fixture(scope="module")
def server():
    from karpenter_tpu_torch.service import SolverServer

    srv = SolverServer(port=0, device="cpu").start_background()
    yield srv
    srv.stop()


@pytest.fixture()
def client(server):
    from karpenter_tpu_torch.service import RemoteSolver

    c = RemoteSolver(*server.address)
    yield c
    c.close()


# ------------------------------------------------------------ codec twin
def _arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "req": rng.random((int(rng.integers(1, 40)), 6)).astype(np.float32),
        "feas": rng.random((16, int(rng.integers(1, 70)))) < 0.5,
        "cfg0": rng.integers(-1, 100, int(rng.integers(0, 30))).astype(np.int32),
        "next0": np.int32(rng.integers(0, 9)).reshape(()),
        "price": rng.random(7).astype(np.float64),
    }


def _store_objects(pkg: str, seed: int) -> dict:
    """Seeded store objects built alike from either package's classes."""
    api = importlib.import_module(f"{pkg}.api")
    objects = importlib.import_module(f"{pkg}.api.objects")
    kube = importlib.import_module(f"{pkg}.state.kube")
    rng = np.random.default_rng(seed)
    taint = objects.Taint(key=f"k{seed}", value="v", effect="NoSchedule")
    pods = [
        api.Pod(
            name=f"p-{seed}-{i}",
            labels={"app": f"a{int(rng.integers(0, 3))}"},
            requests=api.Resources(
                cpu=float(rng.integers(1, 16)) * 0.25,
                memory=f"{int(rng.integers(1, 64))}Mi",
            ),
            tolerations=[objects.Toleration(key=taint.key, operator="Exists")],
            priority=int(rng.integers(0, 5)),
        )
        for i in range(int(rng.integers(1, 6)))
    ]
    node = kube.Node(
        name=f"n-{seed}", labels={"zone": "z1"}, taints=[taint],
        capacity=api.Resources(cpu=8, memory="32Gi"),
    )
    pool = api.NodePool(name=f"pool-{seed}", weight=int(rng.integers(0, 10)),
                        taints=[taint])
    return {"pods": pods, "node": node, "pool": pool, "seq": int(rng.integers(0, 1 << 40)),
            "tags": ("a", 1.5, None, True)}


@pytest.mark.parametrize("seed", range(3))
def test_codec_arrays_byte_equal(seed):
    frames = []
    for pkg in PACKAGES:
        codec = importlib.import_module(f"{pkg}.service.codec")
        frames.append(codec.encode({"method": "pack", "k_slots": 64}, _arrays(seed)))
    assert frames[0] == frames[1]
    from karpenter_tpu_torch.service.codec import decode

    header, out = decode(frames[1])
    assert header == {"method": "pack", "k_slots": 64}
    for name, want in _arrays(seed).items():
        assert out[name].dtype == want.dtype and out[name].shape == want.shape
        np.testing.assert_array_equal(out[name], want)


@pytest.mark.parametrize("seed", range(3))
def test_binwire_store_objects_byte_equal(seed):
    payloads, values = [], []
    for pkg in PACKAGES:
        codec = importlib.import_module(f"{pkg}.service.codec")
        binwire = importlib.import_module(f"{pkg}.state.binwire")
        value = _store_objects(pkg, seed)
        payloads.append(codec.encode_payload(value, codec.CODEC_BIN))
        values.append((binwire, value))
    assert payloads[0] == payloads[1]
    (ref_bw, _), (port_bw, port_value) = values
    assert ref_bw.SCHEMA_FP == port_bw.SCHEMA_FP
    from karpenter_tpu_torch.service.codec import CODEC_BIN, decode_payload

    back = decode_payload(payloads[1], CODEC_BIN)
    assert back == port_value
    assert port_bw.decode_value(port_bw.encode_value(port_value)) == port_value


def test_codec_rejects_a_torn_frame():
    from karpenter_tpu_torch.service.codec import decode, encode

    frame = encode({"method": "ping"}, {})
    for cut in (0, 3, len(frame) - 1):
        with pytest.raises(ValueError):
            decode(frame[:cut])


# ----------------------------------------------------------- entry point
def _entry(*extra: str) -> list:
    """The tick lines of ``python -m karpenter_tpu_torch`` on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch", "--device", "cpu", "--ticks", "2",
         "--interval", "1.1", "--pods", "20", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.splitlines()]


def test_entry_point_packs_through_the_solver_address():
    from karpenter_tpu_torch.service import SolverServer

    srv = SolverServer(port=0, device="cpu").start_background()
    try:
        remote = _entry("--solver-address", "%s:%d" % srv.address)
        packs = srv.registry.counter(
            "karpenter_service_solves_total", {"tenant": "default", "path": "solo"}
        )
    finally:
        srv.stop()
    local = _entry()
    assert packs >= 1
    assert [t["kernel"] for t in remote if t["solves"]] == ["custom"]
    assert [t["kernel"] for t in local if t["solves"]] == ["reference"]
    for key in ("solves", "claims", "pending"):
        assert [t[key] for t in remote] == [t[key] for t in local], key
    assert remote[-1]["claims"] >= 1
