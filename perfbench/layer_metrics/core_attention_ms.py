"""core_attention_ms: device ms a train step of the GTrXL core's attention
kernels in the device-only trace, told by name (``counts/gtrxl.py``'s
``ATTENTION_KERNELS``: PyTorch's memory-efficient attention, forward and
backward), wherever they were launched from: the rollout's CUDA graph
replays acting's, which no span sees into. None where none ran."""

from perfbench.counts.gtrxl import ATTENTION_KERNELS


def read(run):
    trace = run.trace
    seconds = None if trace is None else trace.kernel_seconds(
        ATTENTION_KERNELS)
    if not seconds:
        return None
    return 1e3 * seconds / trace.steps
