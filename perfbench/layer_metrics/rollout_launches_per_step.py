"""rollout_launches_per_step: kernels launched inside the program's
``rollout`` span (its env and policy steps included) a train step
(``harness/program_trace.py``)."""

from perfbench.harness import program_trace


def read(run):
    return program_trace.value(run, "rollout", "launches")
