"""Every name in BENCHMARK.json finds its files, and a new file is found
with no edit to the harness."""

import io
import json
import re
import types

import pytest
import torch

from perfbench.harness import cell as cells
from perfbench.harness import runner
from perfbench.tests.conftest import ROOT, tiny_checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.benchmark()


def test_benchmark_json_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for kind in ("configs", "workloads", "end_to_end",
                                    "per_layer") for e in BENCH[kind]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    cell_names = {w["name"] for w in BENCH["workloads"]}
    ends = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends
        assert set(m["workloads"]) <= cell_names
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert cells.metrics_of(BENCH, w["name"], "per_layer")
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_to_its_files(workload):
    spec = cells.workload(BENCH, workload)
    entry = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
    assert entry["file"].startswith("perfbench/configs/")
    config = cells.config(BENCH, spec["config"])
    assert config["name"] == spec["config"]
    assert set(entry["reduced"]) <= set(config)
    assert cells.traffic(spec["traffic"])["num_envs"] > 0
    builder = cells.module("builders", config["builder"])
    assert callable(builder.build) and callable(builder.check_steps)
    assert {"frozen", "half_batch", "altered"} <= set(builder.FAULTS)
    reference = cells.module("reference", config["reference"])
    assert callable(reference.follow) and callable(reference.compare)
    assert (ROOT / "perfbench" / "reference"
            / f"{config['reference']}.py").exists()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_layer_metric_has_a_reader(metric):
    reader = cells.module("layer_metrics", metric)
    assert callable(reader.read)


def test_a_new_traffic_file_is_picked_up_with_no_other_edit(tmp_path):
    root = tiny_checkout(tmp_path, float32=True)
    (root / "perfbench" / "traffic" / "dummy.json").write_text(json.dumps(
        {"num_envs": 2, "unroll_length": 3, "profile_steps": 1}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dmlab_vtrace.dummy",
                               "config": "dmlab_vtrace", "traffic": "dummy",
                               "chips": 1, "why": "a test's"})
    for m in bench["per_layer"]:
        m["workloads"].append("dmlab_vtrace.dummy")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out, err = io.StringIO(), io.StringIO()
    args = types.SimpleNamespace(workload="dmlab_vtrace.dummy", seed=5,
                                 seconds=0.2, trace=0)
    assert runner.run(args, 0.0, device=torch.device("cpu"), root=root,
                      out=out, err=err) == 0
    line = json.loads(out.getvalue().splitlines()[-1])
    assert line["correct"] is True
    # 2 envs x 3 steps a train step.
    assert line["metrics"]["env_frames_per_s"]["value"] > 0
    assert list(line)[-1] == "check"
