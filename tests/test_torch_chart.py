"""The port's own chart, ``deploy/chart_torch``.

Every case of ``tests/test_deploy.py`` runs over it
(`torch_ported.port_tests`, ``CHART`` pointed at the port's chart): it
renders with the port's ``tools/render_chart.py``, its settings load as
the port's `Settings`, its controller, store and store replica run
``python -m karpenter_tpu_torch`` and its solver
``karpenter_tpu_torch.service.server`` on an ``nvidia.com/gpu``
and its controller requests the memory phase 16 measured (`PORT_WORDS`).
The cases over ``deploy/chart`` stay in
``tests/test_torch_deploy.py``.

The cases below hold what the port's chart adds: ``controller.device``
(the controller's ``--device``, and its card where it is ``cuda``), the
``KARPENTER_TPU_SHARDED`` value, ``diff -r`` against the reference's chart
held to the listed changes, the entry points' exit on SIGTERM, and the
rendered topology run as processes on the CPU (`chip_smoke.chart_topology`:
the store, the solver with ``--device=cpu`` appended by the test, one
controller rendered with ``controller.device=cpu``, 40 of config 2's pods).
"""

import difflib
import pathlib
import signal
import socket
import subprocess
import sys
import time

import pytest
import yaml

from torch_ported import port_tests

REPO = pathlib.Path(__file__).resolve().parent.parent
CHART = "deploy/chart_torch"

PORT_WORDS = [
    ('CHART = "deploy/chart"', f'CHART = "{CHART}"'),
    ('c["resources"]["limits"] == {"google.com/tpu": 1}',
     'c["resources"]["limits"] == {"nvidia.com/gpu": 1}'),
    ('c["resources"]["requests"] == {"cpu": "1", "memory": "1Gi"}',
     'c["resources"]["requests"] == {"cpu": "1", "memory": "6Gi"}'),
]

globals().update(port_tests("test_deploy.py", text=PORT_WORDS))

VALUE_SETS = {
    "default": {"settings.cluster_name": "prod-cluster"},
    "ha": {"settings.cluster_name": "ha", "replicas": "2", "store.enabled": "true"},
    "tenants": {"settings.cluster_name": "x", "service.multiTenant.enabled": "true",
                "service.multiTenant.inflightCap": "8"},
}


def _docs(values):
    from karpenter_tpu_torch.tools.render_chart import render_chart

    out = {}
    for text in render_chart(CHART, dict(values)):
        for d in yaml.safe_load_all(text):
            if d:
                out[(d["kind"], d["metadata"]["name"])] = d
    return out


def _container(docs, name):
    (c,) = docs[("Deployment", name)]["spec"]["template"]["spec"]["containers"]
    return c


@pytest.mark.parametrize("values", VALUE_SETS.values(), ids=VALUE_SETS.keys())
def test_every_workload_runs_the_port(values):
    """Every rendered container starts the port, never the JAX package, and
    no workload is told to run on the CPU."""
    docs = _docs(values)
    for (kind, name), d in docs.items():
        if kind != "Deployment":
            continue
        (c,) = d["spec"]["template"]["spec"]["containers"]
        module = c["command"][2]
        assert module.split(".")[0] == "karpenter_tpu_torch", (name, c["command"])
        assert "--device=cpu" not in c.get("args", []), name
    assert _container(docs, "karpenter-tpu")["command"] == [
        "python", "-m", "karpenter_tpu_torch"]
    assert _container(docs, "karpenter-tpu-solver")["command"][-1] == (
        "karpenter_tpu_torch.service.server")


def test_controller_device_cuda_asks_for_a_card():
    c = _container(_docs(VALUE_SETS["default"]), "karpenter-tpu")
    assert "--device=cuda" in c["args"]
    assert c["resources"]["limits"]["nvidia.com/gpu"] == 1
    assert set(c["resources"]["requests"]) == {"cpu", "memory"}


def test_controller_device_cpu_asks_for_none():
    docs = _docs({**VALUE_SETS["default"], "controller.device": "cpu"})
    c = _container(docs, "karpenter-tpu")
    assert "--device=cpu" in c["args"]
    assert "--device=cuda" not in c["args"]
    assert set(c["resources"]["limits"]) == {"cpu", "memory"}
    # the solver keeps its card
    solver = _container(docs, "karpenter-tpu-solver")
    assert solver["resources"]["limits"] == {"nvidia.com/gpu": 1}


def test_controller_parses_its_rendered_device():
    """The rendered ``--device`` is a choice the entry point accepts."""
    from karpenter_tpu_torch.__main__ import main

    for device in ("cuda", "cpu"):
        c = _container(_docs({**VALUE_SETS["default"], "controller.device": device}),
                       "karpenter-tpu")
        (arg,) = [a for a in c["args"] if a.startswith("--device=")]
        assert main([arg, "--dump-settings"]) == 0


def test_renderer_eq_condition():
    """The port's renderer takes helm's ``eq .Values.path "string"`` atom,
    alone, negated and ``and``-joined; the reference's chart renders as
    before (`tests/test_torch_deploy.py`)."""
    from karpenter_tpu_torch.tools.render_chart import render_template

    text = ('a: 1\n{{ if eq .Values.d "cuda" }}\ngpu: 1\n{{ end }}\n'
            '{{ if not eq .Values.d "cuda" and .Values.s }}\ncpu: 1\n{{ end }}\n')
    assert render_template(text, {"d": "cuda", "s": "true"}) == "a: 1\ngpu: 1\n"
    assert render_template(text, {"d": "cpu", "s": "true"}) == "a: 1\ncpu: 1\n"
    assert render_template(text, {"d": "cpu", "s": "false"}) == "a: 1\n"
    with pytest.raises(KeyError):
        render_template(text, {"s": "true"})


def test_sharded_is_absent_by_default():
    docs = _docs(VALUE_SETS["ha"])
    for name in ("karpenter-tpu", "karpenter-tpu-solver", "karpenter-tpu-store"):
        assert "env" not in _container(docs, name), name


def test_sharded_renders_the_variable_on_controller_and_solver():
    docs = _docs({**VALUE_SETS["ha"], "sharded": "true"})
    for name in ("karpenter-tpu", "karpenter-tpu-solver"):
        assert _container(docs, name)["env"] == [
            {"name": "KARPENTER_TPU_SHARDED", "value": "1"}], name
    assert "env" not in _container(docs, "karpenter-tpu-store")


# what `diff -r deploy/chart deploy/chart_torch` may show, file by file:
# the lines that are not comments, taken out (-) and put in (+)
LISTED_CHANGES = {
    "values.yaml": {
        "-": ["memory: 1Gi", "acceleratorResource: google.com/tpu"],
        "+": ["device: cuda", "memory: 6Gi", "acceleratorResource: nvidia.com/gpu",
              'sharded: "false"'],
    },
    "templates/deployment.yaml": {
        "-": ["- karpenter_tpu"],
        "+": ["- karpenter_tpu_torch", "- --device={{ .Values.controller.device }}",
              "{{ if .Values.sharded }}", "env:", "- name: KARPENTER_TPU_SHARDED",
              'value: "1"', "{{ end }}", '{{ if eq .Values.controller.device "cuda" }}',
              "{{ .Values.solver.acceleratorResource }}: 1", "{{ end }}"],
    },
    "templates/solver-deployment.yaml": {
        "-": ["- karpenter_tpu.service.server"],
        "+": ["- karpenter_tpu_torch.service.server", "{{ if .Values.sharded }}", "env:",
              "- name: KARPENTER_TPU_SHARDED", 'value: "1"', "{{ end }}"],
    },
    "templates/store-deployment.yaml": {"-": ["- karpenter_tpu"],
                                        "+": ["- karpenter_tpu_torch"]},
    "templates/store-replica.yaml": {"-": ["- karpenter_tpu"],
                                     "+": ["- karpenter_tpu_torch"]},
}


def test_diff_against_the_reference_chart_is_the_listed_changes():
    ref, port = REPO / "deploy/chart", REPO / CHART
    files = sorted({p.relative_to(ref) for p in ref.rglob("*") if p.is_file()}
                   | {p.relative_to(port) for p in port.rglob("*") if p.is_file()})
    changes = {}
    for rel in files:
        a, b = ref / rel, port / rel
        assert a.exists() and b.exists(), rel
        lines = {"-": [], "+": []}
        for line in difflib.unified_diff(a.read_text().splitlines(),
                                         b.read_text().splitlines(), lineterm="", n=0):
            if line[:1] in "-+" and not line.startswith(("---", "+++")):
                body = line[1:].strip()
                if body and not body.startswith("#"):
                    lines[line[0]].append(body)
        if lines["-"] or lines["+"] or a.read_text() != b.read_text():
            changes[str(rel)] = lines
    # comments may change only in the files the listed changes touch
    assert set(changes) == set(LISTED_CHANGES), sorted(changes)
    for rel, want in LISTED_CHANGES.items():
        assert changes[rel] == want, rel


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _listening(port: int, proc, timeout: float = 90.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.communicate(timeout=10)
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"nothing listened on {port}")


def _sigterm_exit(argv, port: int) -> int:
    proc = subprocess.Popen([sys.executable, *argv], cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        _listening(port, proc)
        proc.send_signal(signal.SIGTERM)
        return proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_solver_sidecar_exits_0_on_sigterm():
    """The chart's solver container runs ``service.server`` until its pod
    is stopped: SIGTERM ends it with exit code 0."""
    port = _free_port()
    rc = _sigterm_exit(["-m", "karpenter_tpu_torch.service.server", "--device=cpu",
                        "--host=127.0.0.1", f"--port={port}",
                        f"--telemetry-port={_free_port()}"], port)
    assert rc == 0


def test_store_server_exits_0_on_sigterm():
    """The chart's store container, ``python -m karpenter_tpu_torch
    store-server``: SIGTERM ends it with exit code 0."""
    port = _free_port()
    rc = _sigterm_exit(["-m", "karpenter_tpu_torch", "store-server", "--host=127.0.0.1",
                        f"--port={port}", f"--telemetry-port={_free_port()}"], port)
    assert rc == 0


def test_rendered_topology_runs_on_the_cpu():
    """The chart's topology as processes: rendered with the store and the
    multi-tenant solver, ``controller.device=cpu``; the store, the solver
    (``--device=cpu`` appended here: the chart's solver asks for the card)
    and one controller started from their rendered argv; 40 of config 2's
    pods through one store client.  The controller leads, every pod is
    nominated through the sidecar's pack, the claims equal the in-process
    CPU twin's, the controller packed nothing itself, and SIGTERM ends
    every process with exit code 0 (`chip_smoke.chart_topology`; each
    wait has its deadline, and every process is killed if one passes)."""
    import chip_smoke

    r = chip_smoke.chart_topology(
        n_pods=40,
        values={"store.enabled": "true", "service.multiTenant.enabled": "true",
                "controller.device": "cpu"},
        extra_args={"solver": ["--device=cpu"]}, on_card=False, deadline_s=240.0)
    assert r["leader"] == "controller-0"
    assert r["nominated"] == 40 and r["claims"] >= 1
    assert r["rcs"] == {"controller-0": 0, "solver": 0, "store": 0}
    assert r["solves"] >= 1 and r["solver_dispatches"].get("ffd_pack", 0) >= 1
    assert r["controller_uploads"] == {"controller-0": {}}
    assert r["controller_launches"] == {"controller-0": {}}


NO_TORCH = """
import importlib.abc, runpy, sys

class NoTorch(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "torch" or name.startswith("torch."):
            raise ImportError(f"the store server imported {name}")

sys.meta_path.insert(0, NoTorch())
runpy.run_module("karpenter_tpu_torch", run_name="__main__")
"""


def test_store_server_runs_without_torch():
    """The chart's store container, ``python -m karpenter_tpu_torch
    store-server``, loads neither torch nor the CUDA library: a process
    that refuses to import torch serves the store and exits 0 on SIGTERM.
    The store's memory limit is 512Mi; with torch imported the store held
    226-263 MiB at 40-10,000 pods under a CPU build of torch, and 38 MiB
    without it."""
    port = _free_port()
    rc = _sigterm_exit(["-c", NO_TORCH, "store-server", "--host=127.0.0.1", f"--port={port}",
                        f"--telemetry-port={_free_port()}"], port)
    assert rc == 0
