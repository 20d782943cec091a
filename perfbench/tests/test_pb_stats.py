"""The benchmark's arithmetic, against values worked out by hand."""

import statistics

import numpy as np
import pytest

from perfbench.harness import stats


def test_percentile_takes_every_sample_as_numpy_does():
    values = [9.0, 1.0, 5.0, 3.0, 7.0, 2.0, 8.0, 4.0, 6.0, 10.0, 100.0]
    for q in (0, 10, 50, 90, 95, 100):
        assert stats.percentile(values, q) == pytest.approx(
            float(np.percentile(values, q)))
    # 11 values: rank 9 of the sorted list, 10.0; the 100 beyond it counts.
    assert stats.percentile(values, 90) == 10.0
    assert stats.percentile(values[:-1] + [1000.0], 95) == pytest.approx(
        10.0 + 0.5 * (1000.0 - 10.0))


def test_quartile_spread_uses_statistics_quantiles():
    values = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, median, q3 = statistics.quantiles(values, n=4)
    assert stats.quartile_spread(values) == (q3 - q1) / median
    assert stats.quartile_spread(values) == pytest.approx(
        (14.25 - 10.75) / 12.5)


def test_union_and_gaps_of_intervals():
    intervals = [(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (7.0, 8.0), (9.0, 9.5)]
    assert stats.union(intervals) == [(0.0, 3.0), (5.0, 8.0), (9.0, 9.5)]
    assert stats.covered(intervals) == 3.0 + 3.0 + 0.5
    assert stats.gaps(intervals, -1.0, 10.0) == [
        (-1.0, 0.0), (3.0, 5.0), (8.0, 9.0), (9.5, 10.0)]
    assert stats.covered(stats.clip(intervals, 1.5, 6.0)) == 1.5 + 1.0


@pytest.mark.parametrize("workload, frames", [
    ("dmlab_vtrace.envs256_t32", 4 * 5), ("r2d2_atari.ratio010", 8 * 6)])
def test_frames_a_step_count_every_env_eval_envs_included(tmp_path, workload,
                                                          frames):
    import torch

    from perfbench.harness import cell as cells
    from perfbench.tests.conftest import tiny_checkout

    root = tiny_checkout(tmp_path)
    bench = cells.benchmark(root)
    spec = cells.workload(bench, workload)
    config = cells.config(bench, spec["config"], root)
    traffic = cells.traffic(spec["traffic"], root)
    cell = cells.module("builders", config["builder"], root).build(
        config, traffic, 3, torch.device("cpu"),
        cells.module("reference", config["reference"], root))
    # num_envs x unroll_length new timesteps a step, eval envs among them.
    assert cell.frames_per_step == frames
