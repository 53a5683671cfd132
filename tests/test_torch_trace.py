"""The port's span tracer and its device profiler.

Every case of ``tests/test_trace.py`` runs on the port
(`torch_ported.port_tests`), its operators on the CPU (the `on_the_cpu`
fixture): the tracer free when off, nested paths and aggregates, the span
report and dump, `device_trace` a no-op when the tracer is disabled, the
operator's and solver's spans, and the phase collector.

Then the profiler through the deployed process: ``python -m
karpenter_tpu_torch`` on the CPU with ``enable_profiling`` and
``profile_dir`` prints the span report on exit, writes ``spans.json``,
and leaves the ``torch.profiler`` timeline of its solve in the directory.
"""

import json
import pathlib
import subprocess
import sys

import pytest

from torch_ported import on_the_cpu, port_tests  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.usefixtures("on_the_cpu")
globals().update(port_tests("test_trace.py"))


def test_cpu_solve_writes_a_profiler_trace_and_spans(tmp_path):
    prof = tmp_path / "prof"
    settings = tmp_path / "settings.json"
    settings.write_text(json.dumps({"cluster_name": "profiled", "enable_profiling": True,
                                    "profile_dir": str(prof)}))
    proc = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch", "--ticks", "3", "--interval", "0.6",
         "--device", "cpu", "--pods", "20", "--settings-file", str(settings)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    ticks = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    solves = [t for t in ticks if t["solves"]]
    assert len(solves) == 1, ticks
    # the span report on exit: the table's header and the solver's spans
    assert "total_ms" in proc.stdout and "solver.fetch" in proc.stdout
    spans = json.loads((prof / "spans.json").read_text())
    assert spans["stats"]["controller.provisioner"]["count"] == 3
    assert any(k.endswith("solver.pack") for k in spans["stats"])
    traces = sorted(prof.glob("solve-*.pt.trace.json"))
    assert len(traces) == 1, traces
    events = json.loads(traces[0].read_text())["traceEvents"]
    # the plain version's operators ran inside the profiled pack and fetch
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
