"""rollout_idle_ms: device idle ms a train step while the main thread is
inside the program's ``rollout`` span, from a trace with the host's
operators (``harness/program_trace.py``)."""

from perfbench.harness import program_trace


def read(run):
    return program_trace.value(run, "rollout", "idle_ms")
