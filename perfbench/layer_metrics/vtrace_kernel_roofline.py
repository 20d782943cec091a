"""vtrace_kernel_roofline: B1's bound (``counts/bounds.py``) over its
kernel's device time in the trace (``vtrace_forward_kernel``), in %."""

KERNEL = "vtrace_forward_kernel"


def read(run):
    trace = run.trace
    bound = run.cell.kernel_seconds_per_step.get(KERNEL)
    seconds = None if trace is None else trace.kernel_seconds(KERNEL)
    if bound is None or not seconds:
        return None
    return 100.0 * bound * trace.steps / seconds
