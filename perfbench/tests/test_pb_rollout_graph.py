"""``rollout_graph_replays_per_step`` read from hand-built event lists
(``harness/program_trace.py``), as ``test_pb_program_trace.py`` builds
them."""

import types

from perfbench.harness import cell as cells
from perfbench.harness import program_trace as pt

MS = 1_000_000  # ns
NAME = "rollout_graph_replays_per_step"


def span(name, start, end, corr):
    return pt.Event("span", pt.PREFIX + name, 1, start * MS, end * MS, corr)


def graph_launch(span_corr, cupti, at, kernels):
    """A ``cudaGraphLaunch`` under the span ``span_corr`` and its graph's
    kernels on the device."""
    return [pt.Event("runtime", "cudaGraphLaunch", 77, at * MS, at * MS + 1,
                     cupti, span_corr),
            *(pt.Event("kernel", "k", 7, a * MS, b * MS, cupti, span_corr)
              for a, b in kernels)]


def _read(events):
    run = types.SimpleNamespace(program_spans=pt.table(events))
    return cells.module("layer_metrics", NAME).read(run)


def test_reads_the_replays_a_train_step():
    events = []
    for k in range(3):
        t = 100 * k
        events += [span("train_step", t, t + 100, corr=10 * k + 1),
                   span("rollout", t, t + 40, corr=10 * k + 2),
                   span("rollout.graph_replay", t + 5, t + 6,
                        corr=10 * k + 3),
                   *graph_launch(10 * k + 3, 500 + k, t + 5,
                                 [(t + 6, t + 20), (t + 20, t + 30)])]
    assert _read(events) == 1
    table = pt.table(events)
    # A graph's kernels are the rollout's launches.
    assert table["rollout"]["launches"] == 2
    assert table["rollout.graph_replay"]["launches"] == 2


def test_none_where_the_rollout_ran_eagerly():
    events = [span("train_step", 0, 100, corr=1),
              span("rollout", 0, 40, corr=2),
              span("rollout.policy_step", 1, 10, corr=3),
              span("rollout.env_step", 10, 20, corr=4)]
    assert _read(events) is None


def test_none_without_program_spans():
    events = [pt.Event("op", "aten::add", 1, 0, MS, 1)]
    assert _read(events) is None
