"""update_graph_replays_per_step: replays of R2D2's batch-update CUDA graph
a train step, the calls of the program's ``update.graph_replay`` span
(``harness/program_trace.py``); None where the program has no such span
(an eager update)."""

from perfbench.harness import program_trace


def read(run):
    return program_trace.value(run, "update.graph_replay", "calls")
