"""conv_roofline: the nets' convolutions' bound (``counts/bounds.py``,
forward and backward, the traced steps' calls) over the device time of
ATen's convolution ops in the trace, in %."""


def read(run):
    trace = run.trace
    if trace is None or not trace.conv_device_s:
        return None
    bound = run.cell.conv_seconds_per_step * trace.steps
    return 100.0 * bound / trace.conv_device_s
