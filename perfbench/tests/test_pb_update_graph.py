"""``update_graph_replays_per_step`` read from hand-built event lists
(``harness/program_trace.py``), as ``test_pb_program_trace.py`` builds
them."""

import types

from perfbench.harness import cell as cells
from perfbench.harness import program_trace as pt

MS = 1_000_000  # ns
NAME = "update_graph_replays_per_step"


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


def _replayed_step(k, batches):
    """Train step ``k`` with ``batches`` batches, each one graph replay
    inside ``update``."""
    t = 1000 * k
    events = [span("train_step", t, t + 900, corr=100 * k + 1)]
    for b in range(batches):
        u = t + 100 * b
        corr = 100 * k + 10 * b
        events += [span("update", u, u + 90, corr=corr + 2),
                   span("update.graph_replay", u + 5, u + 6, corr=corr + 3),
                   *graph_launch(corr + 3, 5000 + 10 * k + b, u + 5,
                                 [(u + 6, u + 20), (u + 20, u + 30)])]
    return events


def test_reads_the_replays_a_train_step():
    events = [e for k in range(3) for e in _replayed_step(k, 1)]
    assert _read(events) == 1
    table = pt.table(events)
    # A graph's kernels are the update's launches.
    assert table["update"]["launches"] == 2
    assert table["update.graph_replay"]["launches"] == 2


def test_counts_every_batch_s_replay():
    events = [e for k in range(2) for e in _replayed_step(k, 7)]
    assert _read(events) == 7


def test_none_where_the_update_ran_eagerly():
    events = [span("train_step", 0, 100, corr=1),
              span("update", 50, 100, corr=2),
              span("update.loss", 51, 70, corr=3),
              span("update.backward", 70, 90, corr=4)]
    assert _read(events) is None


def test_none_without_program_spans():
    events = [pt.Event("op", "aten::add", 1, 0, MS, 1)]
    assert _read(events) is None
