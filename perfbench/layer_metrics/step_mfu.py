"""step_mfu: the window's model FLOPs (``counts/flops.py``, a train step's
frozen count times the steps, all outside the profiler) over the window's
wall seconds at the H100's dense bf16 peak, in %."""

from perfbench.counts.flops import PEAK_BF16_FLOPS


def read(run):
    flops = run.cell.flops_per_step * run.steps
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS)
