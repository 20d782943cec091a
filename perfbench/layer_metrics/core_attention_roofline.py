"""core_attention_roofline: the GTrXL core's attention bound
(``counts/gtrxl.py``: acting's memory rows read once and its products over
the valid keys, the update's products forward and backward) over its
kernels' device time in the trace, in %."""

from perfbench.counts.gtrxl import ATTENTION_KERNELS


def read(run):
    trace = run.trace
    bound = run.cell.kernel_seconds_per_step.get(ATTENTION_KERNELS)
    seconds = None if trace is None else trace.kernel_seconds(
        ATTENTION_KERNELS)
    if bound is None or not seconds:
        return None
    return 100.0 * bound * trace.steps / seconds
