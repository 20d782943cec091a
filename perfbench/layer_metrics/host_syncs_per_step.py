"""host_syncs_per_step: the host's waits for the device inside the
program's ``train_step`` span (stream, device and event synchronizes,
blocking copies) a train step; 0 is a reading
(``harness/program_trace.py``)."""

from perfbench.harness import program_trace


def read(run):
    return program_trace.value(run, "train_step", "syncs")
