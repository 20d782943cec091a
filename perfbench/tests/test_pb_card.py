"""A whole run on the card, through the command BENCHMARK.json names."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench.tests.conftest import ROOT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_on_the_card_prints_a_correct_line(card, trace):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload = bench["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 5), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
