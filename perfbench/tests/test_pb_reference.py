"""The plain references against the port at a tiny size on the CPU, and
the control, which the limits have to refuse."""

import pytest
import torch

from perfbench.harness import cell as cells
from perfbench.reference import common
from perfbench.tests.conftest import tiny_checkout

CELLS = ["dmlab_vtrace.envs256_t32", "r2d2_atari.ratio010"]


def readings(root, workload, seed, precision=None):
    bench = cells.benchmark(root)
    spec = cells.workload(bench, workload)
    config = cells.config(bench, spec["config"], root)
    traffic = cells.traffic(spec["traffic"], root)
    builder = cells.module("builders", config["builder"], root)
    reference = cells.module("reference", config["reference"], root)
    cell = builder.build(config, traffic, seed, torch.device("cpu"),
                         reference)
    program, inputs = builder.check_steps(cell, config["check_steps"])
    followed = reference.follow(config, traffic, inputs, common.Precision(),
                                torch.device("cpu"))
    numbers = reference.compare(program, followed)
    control = None
    if precision is not None:
        control = reference.compare(
            reference.follow(config, traffic, inputs, precision(config),
                             torch.device("cpu")), followed)
    return config, numbers, control


@pytest.mark.parametrize("workload", CELLS)
def test_reference_follows_a_float32_program_to_rounding(tmp_path, workload):
    root = tiny_checkout(tmp_path, float32=True)
    _, numbers, _ = readings(root, workload, 11)
    assert numbers.pop("sample", 0.0) == 0.0
    # The losses after the first step and the change after the last follow
    # weights that Adam moved: where a gradient is near zero, rounding
    # turns its step by ±lr on either side, in float32 too.
    later = {n: numbers.pop(n) for n in ("loss", "change") if n in numbers}
    assert max(numbers.values()) < 1e-3, numbers
    assert max(later.values()) < 0.1, later


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tmp_path, workload):
    root = tiny_checkout(tmp_path)
    config, numbers, control = readings(root, workload, 12,
                                        common.Precision.control)
    limits = config["limits"]
    assert any(control[n] > limits[n] for n in limits), (control, limits)


def test_control_types_are_a_step_below_the_stated_ones():
    x = torch.tensor([1.0 + 2 ** -12, 3.0, -0.1234567], dtype=torch.float32)
    assert common.ROUNDING["tf32"](x)[0] == 1.0  # 10 mantissa bits
    assert common.ROUNDING["bfloat16"](x)[2] == x[2].to(torch.bfloat16).float()
    scaled = common.ROUNDING["float8"](x)  # e4m3: 3 mantissa bits
    assert torch.allclose(scaled, x, rtol=2 ** -4) and (scaled != x).any()
    assert common.BELOW == {"bfloat16": "float8", "float32": "tf32"}


@pytest.mark.parametrize("workload", CELLS)
def test_an_env_output_unlike_the_formula_is_counted(tmp_path, workload):
    root = tiny_checkout(tmp_path, float32=True)
    bench = cells.benchmark(root)
    config = cells.config(bench, cells.workload(bench, workload)["config"],
                          root)
    traffic = cells.traffic(cells.workload(bench, workload)["traffic"], root)
    builder = cells.module("builders", config["builder"], root)
    reference = cells.module("reference", config["reference"], root)
    cell = builder.build(config, traffic, 13, torch.device("cpu"), reference)
    _, inputs = builder.check_steps(cell, config["check_steps"])
    unroll = dict(inputs["unrolls"][-1])
    unroll["observation"] = unroll["observation"].clone()
    unroll["observation"][-1, 0, 3, 2, 0] += 1
    unroll["reward"] = unroll["reward"].clone()
    unroll["reward"][-1, 1] += 1.0
    altered = dict(inputs, unrolls=inputs["unrolls"][:-1] + [unroll])
    followed = reference.follow(config, traffic, altered, common.Precision(),
                                torch.device("cpu"))
    assert followed["env"] == 2
