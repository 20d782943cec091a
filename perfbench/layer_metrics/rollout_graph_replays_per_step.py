"""rollout_graph_replays_per_step: replays of the rollout's CUDA graph a
train step, the calls of the program's ``rollout.graph_replay`` span
(``harness/program_trace.py``); None where the program has no such span
(an eager rollout)."""

from perfbench.harness import program_trace


def read(run):
    return program_trace.value(run, "rollout.graph_replay", "calls")
