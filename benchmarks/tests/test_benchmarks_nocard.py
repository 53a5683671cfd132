"""A run on a machine without an NVIDIA card fails and prints no result,
and a card test that drives one short run where a card is there."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmarks import harness as H


def run(*args, **env):
    return subprocess.run([sys.executable, "benchmarks/run.py", *args], cwd=H.ROOT,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, **env})


def test_no_card_no_result():
    out = run("--workload", "live500-admit", "--seed", "1", "--seconds", "1", "--trace", "0",
              CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 2 and out.stdout == ""
    assert "NVIDIA" in out.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_one_short_run_on_the_card(card):
    out = run("--workload", "live500-admit", "--seed", str(2**32 + 5), "--seconds", "3",
              "--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"admit_p95_ms", "setup_s"}
