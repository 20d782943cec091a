"""torso_fwd_ms: device ms a train step of the kernels launched inside the
program's ``torso`` spans: every torso forward, the rollout's and the
unroll's, whatever runs its convs; the backward's kernels are not inside
it (``harness/program_trace.py``)."""

from perfbench.harness import program_trace


def read(run):
    return program_trace.value(run, "torso", "device_ms")
