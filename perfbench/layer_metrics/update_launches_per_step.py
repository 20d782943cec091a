"""update_launches_per_step: kernels launched inside the program's
``update`` spans a train step: the loss, backward and optimizer, and for
R2D2 each batch's sample, gather and priority write-back
(``harness/program_trace.py``)."""

from perfbench.harness import program_trace


def read(run):
    return program_trace.value(run, "update", "launches")
