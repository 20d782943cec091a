"""A run with its timed path broken underneath comes out not correct, once
for each fault its cell can have; a sound one comes out correct. The runs
skip the look for a chip and run the rest on the CPU, every net in
float32, at a tiny size."""

import io
import json
import types

import pytest
import torch

from perfbench.harness import cell as cells
from perfbench.harness import runner
from perfbench.tests.conftest import tiny_checkout

CELLS = ["dmlab_vtrace.envs256_t32", "r2d2_atari.ratio010"]


def run(root, workload, fault=None):
    plant = None
    if fault is not None:
        bench = cells.benchmark(root)
        config = cells.config(bench, cells.workload(bench, workload)["config"],
                              root)
        plant = cells.module("builders", config["builder"],
                             root).FAULTS[fault]
    out, err = io.StringIO(), io.StringIO()
    args = types.SimpleNamespace(workload=workload, seed=2**31 + 77,
                                 seconds=0.2, trace=0)
    assert runner.run(args, 0.0, device=torch.device("cpu"), plant=plant,
                      root=root, out=out, err=err) == 0
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(tmp_path, workload):
    line = run(tiny_checkout(tmp_path, float32=True), workload)
    assert line["correct"] is True, line["check"]


@pytest.mark.parametrize("workload,fault", [
    (workload, fault) for workload in CELLS
    for fault in ("frozen", "half_batch", "altered")] + [
    ("r2d2_atari.ratio010", "unweighted")])
def test_a_broken_run_is_not_correct(tmp_path, workload, fault):
    line = run(tiny_checkout(tmp_path, float32=True), workload, fault)
    assert line["correct"] is False, line["check"]
