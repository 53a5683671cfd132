"""BENCHMARK.json against the benchmark's contract, and the rule that the
harness loads neither JAX nor the JAX package, nor the program's helpers."""

from __future__ import annotations

import ast
import re
import sys

import pytest

from benchmarks import harness as H
from benchmarks import run as RUN

M = H.load_json(H.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in M["end_to_end"]}
CELLS = {w["name"]: w for w in M["workloads"]}


def test_top_level_keys_and_paths():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["paths"] == ["benchmarks"] and M["command"] == ["python3", "benchmarks/run.py"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    # a full check of 24 cells fits the driver's budget at this length
    assert 2 + 14 * 24 <= 43200 and (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + M["end_to_end"] + M["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_bounds_and_setup():
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_its_metrics(cell):
    c = H.Cell(cell, M)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert CELLS[cell]["chips"] == 1
    assert (H.BENCH / "traffic" / f"{CELLS[cell]['traffic']}.json").exists()


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_per_layer_arrows(metric):
    """A per-layer metric moves one end-to-end metric that every one of its
    cells reports, and has a reader of its own."""
    moved = E2E[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in CELLS and cell in moved.get("workloads", CELLS)
    assert (H.BENCH / "layer_metrics" / f"{metric['name']}.py").exists()


@pytest.mark.parametrize("layer", sorted({m["layer"] for m in M["per_layer"]}))
def test_layers_named_as_perf_md_lists_them(layer):
    """A metric's layer is one of PERF.md's list of layers, letter for
    letter, so metrics of one layer give the same name."""
    text = (H.ROOT / "PERF.md").read_text()
    section = text[text.index("## 3. Layers"):text.index("## 4.")]
    assert f"`{layer}`" in section


def test_config_files_and_reductions():
    for c in M["configs"]:
        assert c["file"].startswith("benchmarks/configs/") and (H.ROOT / c["file"]).exists()
        assert c["reduced"] == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


HARNESS = [p for p in H.BENCH.rglob("*.py") if "tests" not in p.parts]


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(H.BENCH)))
def test_no_jax_and_no_program_helpers(path):
    """Top-level names compared whole: ``karpenter_tpu_torch`` is the port
    and allowed, ``karpenter_tpu`` is the JAX package and is not."""
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in RUN.FORBIDDEN, (path, mod)
        assert top not in ("chip_smoke", "bench") and mod != "karpenter_tpu_torch.testing", (path, mod)
        if "reference" in path.parts or path.name in ("inputs.py",):
            assert top != "karpenter_tpu_torch", (path, mod)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "karpenter_tpu_torch_x", sys)
    assert "karpenter_tpu" not in RUN.forbidden_modules()
    monkeypatch.setitem(sys.modules, "karpenter_tpu.sub", sys)
    assert RUN.forbidden_modules() == ["karpenter_tpu"]
