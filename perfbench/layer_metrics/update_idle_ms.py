"""update_idle_ms: device idle ms a train step while the main thread is
inside the program's ``update`` spans, from a trace with the host's
operators (``harness/program_trace.py``)."""

from perfbench.harness import program_trace


def read(run):
    return program_trace.value(run, "update", "idle_ms")
